"""The yardstick's arithmetic: the H100's peaks, the bytes and operations
each kernel launch needs, and the model FLOPs of the tokens processed.

The work of a launch is counted from the shapes recorded at the port's
``kernels.ops`` entry, each input byte read once and each output byte
written once, whatever the kernel reads again; the model FLOPs are
counted from the configuration and the tokens, whatever implements them.
``bound``, ``kept_pairs``, ``flash_bwd_work``, ``gmm_bwd_work``,
``ssd_work`` and ``ssd_bwd_work`` are frozen copies of the counts the
port's chip smoke test prints beside each kernel's time.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(n_bytes: float, flops: float, bf16: bool = True):
    """The least time (s) for the bytes at HBM bandwidth and the
    operations at the dtype's peak, and which of the two binds."""
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    bytes_s, ops_s = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                 else "operations")


def kept_pairs(sq, sk, causal, window, q_offset):
    """(query, key) pairs the mask keeps, and the rows that keep none."""
    pairs = empty = 0
    for i in range(sq):
        qp = q_offset + i
        lo = max(0, qp - window + 1) if window else 0
        hi = min(qp, sk - 1) if causal else sk - 1
        pairs += max(0, hi - lo + 1)
        empty += hi < lo
    return pairs, empty


def flash_bwd_work(b, h, kv, s, hd, vd, causal, window):
    """(bytes, operations, kept pairs, rows without a key) K3's backward
    needs in bf16 at self-attention over ``s`` positions: q, o, dO, k and
    v read and dq, dk and dv written once, the LSE read; five products a
    kept pair — S and dP recomputed once, dV, dK, dQ — 2 (3 hd + 2 vd)
    operations."""
    pairs, empty = kept_pairs(s, s, causal, window, 0)
    n_bytes = (2 * (b * h * s * (2 * hd + 2 * vd)
                    + 2 * b * kv * s * (hd + vd)) + 4 * b * h * s)
    flops = 2 * (3 * hd + 2 * vd) * b * h * pairs
    return n_bytes, flops, pairs, empty


def gmm_bwd_work(e, c, d, f, elem=2):
    """((bytes, operations) of K5's backward pair, and of one of its
    products alone): the pair reads x, w and dy and writes dx and dw
    once, two products of 2 E C D F operations; a product reads its two
    operands and writes its result once."""
    xs, ws, ys = e * c * d, e * d * f, e * c * f
    return ((elem * (2 * xs + 2 * ws + ys), 4 * e * c * d * f),
            (elem * (xs + ws + ys), 2 * e * c * d * f))


def ssd_work(b, s, nh, hd, ds, chunk):
    """(bytes, operations) one K6 scan needs, in f32."""
    n_bytes = 4 * (2 * b * s * nh * hd + b * s * nh + nh + 2 * b * s * ds)
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    carried = sum(lens[1:]) + sum(lens[:-1])
    flops = b * (2 * pairs * ds + nh * (2 * pairs * hd
                                        + 2 * carried * hd * ds))
    return n_bytes, flops


def ssd_bwd_work(b, s, nh, hd, ds, chunk):
    """(bytes, operations) K6's backward needs, in f32."""
    n_bytes = 4 * (3 * b * s * nh * hd + 2 * b * s * nh + 2 * nh
                   + 4 * b * s * ds)
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    flops = b * (6 * pairs * ds + nh * (
        4 * pairs * hd + 4 * sum(lens[1:]) * hd * ds
        + 6 * sum(lens[:-1]) * hd * ds))
    return n_bytes, flops


# ------------------------------------------------------- per-launch work
def causal_pairs(sq: int, sk: int, q_offset: int) -> int:
    """Kept pairs of causal attention without a window (closed form of
    :func:`kept_pairs`)."""
    first = min(q_offset, sk - 1) + 1  # keys of row 0
    last_q = q_offset + sq - 1
    if last_q <= sk - 1:
        return sq * first + sq * (sq - 1) // 2
    full = max(0, sk - 1 - q_offset + 1)  # rows before the keys run out
    return full * first + full * (full - 1) // 2 + (sq - full) * sk


def flash_fwd_work(b, h, kv, sq, sk, hd, vd, q_offset, elem=2):
    """(bytes, operations) of one K3 forward launch, causal, no window:
    q, k, v read and the output written once; QK^T and PV over the kept
    pairs."""
    pairs = causal_pairs(sq, sk, q_offset)
    n_bytes = elem * (b * h * sq * (hd + vd) + b * kv * sk * (hd + vd))
    return n_bytes, 2 * (hd + vd) * b * h * pairs


def paged_decode_work(lens, heads_per_kv: int, hd: int, elem=2):
    """(bytes, operations) of one K1 launch over rows of ``lens`` (one
    per query head, ``heads_per_kv`` adjacent rows sharing a kv head):
    each group's keys and values up to its length read once, every q row
    read and its output written once; QK^T and PV over each row's keys."""
    rows = len(lens)
    kv_tokens = sum(int(n) for n in lens[::heads_per_kv])
    n_bytes = elem * (2 * kv_tokens * hd + 2 * rows * hd) + 4 * rows
    flops = 4 * hd * sum(int(n) for n in lens)
    return n_bytes, flops


# ------------------------------------------------------------ model FLOPs
def layer_params_per_token(model: dict) -> int:
    """Weights of one layer that a token is multiplied by: the attention
    projections, and the MLP or the router and its top-k experts."""
    d, H, KV, hd = (model["hidden_size"], model["num_attention_heads"],
                    model["num_key_value_heads"], model["head_dim"])
    f = model["intermediate_size"]
    attn = d * H * hd * 2 + d * KV * hd * 2
    E = model.get("num_local_experts", 0)
    ffn = (d * E + model["num_experts_per_tok"] * 3 * d * f) if E else 3 * d * f
    return attn + ffn


def forward_flops(model: dict, tokens: int, ctx_sum: int, logit_rows: int):
    """Model FLOPs of a forward over ``tokens`` tokens whose keys sum to
    ``ctx_sum`` per layer and head, with ``logit_rows`` rows unembedded."""
    L, H, hd = (model["num_hidden_layers"], model["num_attention_heads"],
                model["head_dim"])
    return (2 * L * layer_params_per_token(model) * tokens
            + 4 * L * H * hd * ctx_sum
            + 2 * model["hidden_size"] * model["vocab_size"] * logit_rows)


def train_step_flops(model: dict, batch: int, seq: int) -> int:
    """6 x the weights each token touches (the unembedding included) and
    3 x causal attention's forward products, over ``batch`` x ``seq``
    tokens; remat's recompute not counted."""
    ctx = batch * seq * (seq + 1) // 2
    return 3 * forward_flops(model, batch * seq, ctx, batch * seq)
