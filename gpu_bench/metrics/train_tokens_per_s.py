"""Tokens of every whole step run in the window, over the time from the
window's opening to the end of its last step."""


def read(rec):
    if rec["kind"] != "train" or not rec["step_ends"]:
        return None
    return (len(rec["step_ends"]) * rec["batch"] * rec["seq"]
            / rec["step_ends"][-1])
