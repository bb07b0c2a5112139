"""A CPU rehearsal of ``chip_smoke.py``'s ``spmd`` and ``dryrun`` phases,
so that their checks run here before the card.

``spmd``: the phase's own functions at smoke width (granite-moe and
internlm2 ``.smoke()``; granite cut to the phase's 4 layers; a batch of
TRAIN_BATCH × 64 positions) on a gloo one-rank 1×1 mesh, with the card's
calls stubbed (``torch.cuda.synchronize``/``empty_cache``) and each
kernel wrapper (K3, K3's backward, K5, K5's backward, K1) replaced by
its plain version
that bumps the wrapper's launch counter, and ``ops`` routing CPU tensors
to the wrappers: every check of the phase runs — the bit-equal losses,
grad norms, leaves and logits with and without rules, and the launch
counts predicted for the card.  ``dryrun``: the phase itself, its
DRYRUN_CELLS as on the card (each cell a process of the CLI).
``dryrun-memory``: the phase at smoke width (4 layers, TRAIN_BATCH × 64),
the card's memory calls standing for a ``ProgramCounter`` over the real
CPU step (its live bytes above the step's entry): the dry-run's count on
fake DTensors equals the plain step's on real tensors, byte for byte.
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as _flash  # noqa: E402
from repro_torch.kernels import grouped_matmul as _gmm  # noqa: E402
from repro_torch.kernels import ops, paged_decode, ref  # noqa: E402
from repro_torch.launch.dryrun import ProgramCounter  # noqa: E402
from repro_torch.launch.mesh import destroy_mesh_group  # noqa: E402
from repro_torch.models import init_model  # noqa: E402


def _counted(wrapper, plain):
    def launch(*args, **kwargs):
        wrapper.launches += 1
        return plain(*args, **kwargs)
    return launch


def _flash_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                 return_lse=False):
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    if return_lse:
        return out, torch.zeros(q.shape[:-1], dtype=torch.float32)
    return out


def _flash_bwd_plain(q, k, v, out, dout, lse, *, causal, window, q_offset):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = ref.flash_attention_ref(*leaves, causal=causal, window=window,
                                    q_offset=q_offset)
        return torch.autograd.grad(o, leaves, dout)


@pytest.fixture
def rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(ops, "_on_cpu", lambda q: ops._PLAIN.get())
    for module, name, plain in (
        (_flash, "flash_attention", _flash_plain),
        (_flash, "flash_attention_bwd", _flash_bwd_plain),
        (_gmm, "grouped_matmul", ref.grouped_matmul_ref),
        (_gmm, "grouped_matmul_bwd", ref.grouped_matmul_bwd_ref),
        (paged_decode, "paged_decode_attention",
         lambda *a, q_per_kv=1: ref.paged_decode_attention_ref(*a)),
    ):
        monkeypatch.setattr(module, name,
                            _counted(getattr(module, name), plain))
    destroy_mesh_group()
    yield
    destroy_mesh_group()
    ops.reset_launch_counts()


def test_spmd_phase_rehearsal(rehearsal, capsys):
    archs = {name: ARCHS[name].smoke()
             for name in ("granite-moe-3b-a800m", "internlm2-1.8b")}
    runs = chip_smoke.spmd_phase(torch, archs, init_model, ops, "cpu")
    assert len(runs) == 5  # train: plain, rules, plain; serve: rules, plain
    assert runs[0]["launches"]["grouped_matmul"] > 0
    assert runs[3]["launches"]["paged_decode_attention"] > 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if '"phase": "spmd"' in ln]
    assert len(line) == 1 and '"backend": "gloo"' in line[0]
    assert not torch.distributed.is_initialized()


def test_dryrun_phase_rehearsal(tmp_path):
    cells = chip_smoke.dryrun_phase(torch, "cpu", out_dir=tmp_path)
    assert [c["rc"] for c in cells] == [0] * len(chip_smoke.DRYRUN_CELLS)
    assert {c["mesh"] for c in cells} == {"16x16", "2x16x16"}


def test_dryrun_memory_phase_rehearsal(rehearsal, monkeypatch, capsys):
    counters = []

    def reset_peak():
        counters.append(ProgramCounter().__enter__())

    def max_allocated():
        counters[-1].__exit__(None, None, None)
        return counters[-1].peak

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset_peak)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", max_allocated)
    archs = {"granite-moe-3b-a800m": ARCHS["granite-moe-3b-a800m"].smoke()}
    rel = chip_smoke.dryrun_memory_phase(torch, archs, init_model, ops, "cpu")
    assert rel == 0.0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if '"phase": "dryrun-memory"' in ln]
    assert len(line) == 1 and '"measured_peak_bytes": ' in line[0]
    assert not torch.distributed.is_initialized()
