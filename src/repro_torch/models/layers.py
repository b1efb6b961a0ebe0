"""Model building blocks as plain functions on tensors, in the reference's dtypes.

Activations are bfloat16; softmax, normalisation statistics and the
attention, SSD and router products are float32.  Where the reference asks an
einsum of bfloat16 operands for a float32 result
(``preferred_element_type=jnp.float32``), the port casts the bfloat16
operands to float32 first: their products are then exact and the sums
accumulate in float32, as the reference's do.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh

BF16 = torch.bfloat16
F32 = torch.float32


@contextlib.contextmanager
def reference_precision():
    """cuBLAS reductions at full precision for the duration, restored after.

    PyTorch lets cuBLAS reduce bfloat16 products in bfloat16
    (``allow_bf16_reduced_precision_reduction``, on by default) and take
    TF32 for float32 products (``allow_tf32``); the reference reduces both
    in float32.  The flags only act on CUDA tensors."""
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = False, False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved


def _f32(x):
    """bfloat16 values widened to float32 (exact)."""
    return x.to(BF16).to(F32)


# ---------------------------------------------------------------------------
# norms / positional
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps=1e-6):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps=1e-5):
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def rope(x, positions, theta: float):
    """x: (..., S, H, D) rotary over last dim; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device) / half))
    ang = positions[..., :, None].to(F32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (online-softmax, chunked — bounded memory at any sequence length)
# ---------------------------------------------------------------------------


NEG_INF = -1e30

# Statically skip fully-masked causal blocks (halves attention work at long
# sequence).  Off by default, as in the reference.
_BLOCK_SKIP = contextvars.ContextVar("flash_block_skip", default=False)


@contextlib.contextmanager
def causal_block_skipping():
    tok = _BLOCK_SKIP.set(True)
    try:
        yield
    finally:
        _BLOCK_SKIP.reset(tok)


def flash_attention(q, k, v, *, causal=True, window=0, q_chunk=512, k_chunk=1024,
                    q_offset=0):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D), H = KV·G.

    Online softmax over KV chunks inside a loop over Q chunks: peak memory is
    O(q_chunk·k_chunk) per head group instead of O(Sq·Sk).
    ``q_offset``: absolute position of q[0] (prefill continuation / decode).
    ``window`` > 0 ⇒ sliding-window attention (|i-j| < window).

    The chunks are the reference's; where Sq or Sk is not a multiple of its
    chunk, the last chunk is ragged.  The reference pads it instead: its
    padded query rows are dropped from the output and its padded keys are
    masked, so they add exact zeros; the port computes neither.

    Under `causal_block_skipping()` each q chunk only visits the KV chunks
    that can be unmasked (j ≤ i, and j ≥ i − ⌈window/ck⌉ for sliding windows).
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    nq = -(-sq // q_chunk)
    nk = -(-sk // k_chunk)
    qg = q.reshape(b, sq, kv, g, d)
    dev = q.device
    pos_q = torch.arange(sq, device=dev) + q_offset
    pos_k = torch.arange(sk, device=dev)
    skip = _BLOCK_SKIP.get() and causal

    outs = []
    for iq in range(nq):
        lo, hi = 0, nk
        if skip:
            hi = min(nk, (iq + 1) * q_chunk // k_chunk + 1)  # j·ck ≤ (iq+1)·cq
            if window:
                lo = max(0, (iq * q_chunk - window) // k_chunk)
        rows = slice(iq * q_chunk, min((iq + 1) * q_chunk, sq))
        qc = _f32(qg[:, rows])  # (B, cq, KV, G, D)
        qpos = pos_q[rows]
        cq = qc.shape[1]
        m = torch.full((b, kv, g, cq), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((b, kv, g, cq), dtype=F32, device=dev)
        acc = torch.zeros((b, kv, g, cq, d), dtype=F32, device=dev)
        for j in range(lo, hi):
            cols = slice(j * k_chunk, min((j + 1) * k_chunk, sk))
            kpos = pos_k[cols]
            s = torch.einsum("bqkgd,bckd->bkgqc", qc, _f32(k[:, cols])) * scale
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            else:
                mask = torch.ones((cq, kpos.shape[0]), dtype=torch.bool, device=dev)
            if window:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", _f32(p), _f32(v[:, cols]))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, t, *, window=0):
    """Single-token attention against a (B, Smax, KV, D) cache; t = current len.

    Memory-bound flash-decoding shape: scores (B, KV, G, Smax) in fp32.
    ``t`` is an int or a 0-d tensor on the cache's device.
    """
    b, _, h, d = q.shape
    _, smax, kv, _ = k_cache.shape
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qh = q.reshape(b, kv, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", _f32(qh), _f32(k_cache)) * scale
    pos = torch.arange(smax, device=q.device)
    mask = pos < t
    if window:
        mask = mask & (pos >= t - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", _f32(p), _f32(v_cache))
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# feed-forward / MoE
# ---------------------------------------------------------------------------


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ffn(x, w1, w2, w3=None, act="swiglu"):
    if act == "swiglu":
        h = F.silu(x @ w1) * (x @ w3)
    else:
        h = gelu(x @ w1)
    return h @ w2


def moe_ffn(x, router_w, w1, w2, w3, *, top_k: int, capacity_factor: float = 1.25,
            n_shared: int = 0, sw1=None, sw2=None, sw3=None):
    """Capacity-based top-k MoE with token dropping.

    x: (T, d); router_w: (d, E); w1/w3: (E, d, f); w2: (E, f, d).
    Each token's k expert outputs are gathered back and summed in a fixed
    order, so two runs on a CUDA card give the same bytes.

    On DTensors (``sharding.TokenRows``' rule) each rank routes its own
    tokens with the one-device capacity positions, dispatches their entries
    for its own experts, and combines its tokens from them; the expert
    products run on the expert-sharded weights.  There the returned router
    probabilities carry no gradient (the model reads none).
    """
    shared_x = x
    rows = sh.TokenRows(x, w1) if sh.is_dtensor(x) else None
    if rows is None:
        # the routed uses read x through one node on both paths: x's gradient
        # is then (routed sum) + shared, grouped alike on one device and on a
        # mesh (bit-equal on a one-rank mesh)
        x, router, t = x.view_as(x), router_w, x.shape[0]
    else:
        x, router, t = rows.local(x), rows.weight(router_w), rows.n
    tl, d = x.shape  # this rank's tokens (all t on one device)
    e = router_w.shape[1]
    logits = x.to(F32) @ router.to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)  # (T, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    cap = int(capacity_factor * top_k * t / e) + 1
    flat_e = idx.reshape(-1)  # (T·k,)
    flat_tok = torch.arange(tl, device=x.device).repeat_interleave(top_k)
    flat_gate = gate.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_tok[order], flat_gate[order]
    # bincount's length depends on the data; a fixed-length count runs under FakeTensorMode too
    counts = torch.zeros(e, dtype=se.dtype, device=se.device).index_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tl * top_k, device=x.device) - starts[se]
    earlier = rows.before(counts) if rows is not None else None
    if earlier is not None:  # the same expert's entries of the tokens before this rank's
        pos = pos + earlier[se]
    keep = pos < cap
    if rows is not None:  # this rank's experts only: the others' entries land in a spill row too
        keep = keep & (se >= rows.e0) & (se < rows.e0 + rows.ne)
        se = torch.where(keep, se - rows.e0, 0)
    pos_c = torch.where(keep, pos, cap)  # dropped tokens land in a spill row

    # the spill row is written with zeros, so its bytes do not depend on which
    # of the colliding writes lands last; it is multiplied by keep = 0 below
    buf = torch.zeros((rows.ne if rows is not None else e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[se, pos_c] = torch.where(keep[:, None], x[st], torch.zeros((), dtype=x.dtype, device=x.device))
    if rows is not None:
        buf = rows.summed(buf)
    h = torch.einsum("ecd,edf->ecf", buf, w1.to(x.dtype))
    if w3 is not None:
        h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, w3.to(x.dtype))
    else:
        h = gelu(h)
    eo = torch.einsum("ecf,efd->ecd", h, w2.to(x.dtype))
    if rows is not None:
        eo = rows.whole(eo)

    contrib = eo[se, pos_c] * (sg * keep)[:, None].to(x.dtype)
    # back to (token, slot) order, then each token's k contributions summed
    out = contrib[torch.argsort(order)].reshape(tl, top_k, d).sum(dim=1)
    if rows is not None:
        out, probs = rows.place(out), rows.place_rows(probs.detach())
    if n_shared:
        out = out + ffn(shared_x, sw1.to(x.dtype), sw2.to(x.dtype), sw3.to(x.dtype), act="swiglu")
    return out, probs


# ---------------------------------------------------------------------------
# Mamba2 / SSD (chunked state-space duality algorithm)
# ---------------------------------------------------------------------------


def ssd_chunked(xh, dt, a_log, b_in, c_in, d_skip, *, chunk: int = 128, h0=None):
    """Chunked SSD scan.  xh: (B, S, NH, HD); dt: (B, S, NH);
    b_in/c_in: (B, S, NS); a_log: (NH,); d_skip: (NH,).

    Returns (y: (B, S, NH, HD), h_final: (B, NH, HD, NS)).
    Memory: O(S·NS + (S/chunk)·NH·HD·NS) — never the full outer-product history.
    """
    b, s, nh, hd = xh.shape
    ns = b_in.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xh = sh.pad(xh, (0, 0, 0, 0, 0, pad))
    dt = sh.pad(dt, (0, 0, 0, pad))
    b_in = sh.pad(b_in, (0, 0, 0, pad))
    c_in = sh.pad(c_in, (0, 0, 0, pad))

    # per-step log-decay: log a_t = −exp(A_log)·dt  (Mamba2 scalar-identity A)
    loga = -torch.exp(a_log.to(F32))[None, None] * dt  # (B, S', NH)
    xdt = xh.to(F32) * dt[..., None]  # dt-scaled input

    def to_chunks(z):
        return z.reshape((b, nc, chunk) + tuple(z.shape[2:]))

    xc = to_chunks(xdt)  # (B, nc, c, NH, HD)
    lc = to_chunks(loga)  # (B, nc, c, NH)
    bc = to_chunks(b_in.to(F32))  # (B, nc, c, NS)
    cc = to_chunks(c_in.to(F32))

    h = torch.zeros((b, nh, hd, ns), dtype=F32, device=xh.device) if h0 is None else h0
    iota = torch.arange(chunk, device=xh.device)
    causal = (iota[:, None] >= iota[None, :])[None, :, :, None]
    ys = []
    for j in range(nc):
        xcj, lcj, bcj, ccj = xc[:, j], lc[:, j], bc[:, j], cc[:, j]
        cum = sh.along(lambda z: torch.cumsum(z, dim=1), lcj, 1)  # (B, c, NH) inclusive
        total = cum[:, -1]  # (B, NH)
        # intra-chunk: y[i] += Σ_{j≤i} exp(cum_i − cum_j)·(c_i·b_j)·xdt_j
        li = cum[:, :, None, :] - cum[:, None, :, :]  # (B, ci, cj, NH)
        w = torch.where(causal, torch.exp(li), 0.0)
        sbc = torch.einsum("bis,bjs->bij", ccj, bcj)  # (B, ci, cj)
        y_intra = torch.einsum("bijh,bij,bjhd->bihd", w, sbc, xcj)
        # inter-chunk: y[i] += c_i · (exp(cum_i)·h_prev)
        y_inter = torch.einsum("bis,bih,bhds->bihd", ccj, torch.exp(cum), h)
        # carried state: h' = exp(total)·h + Σ_j exp(total − cum_j)·b_j ⊗ xdt_j
        decay_j = torch.exp(total[:, None] - cum)  # (B, c, NH)
        h_add = torch.einsum("bjh,bjs,bjhd->bhds", decay_j, bcj, xcj)
        h = torch.exp(total)[..., None, None] * h + h_add
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, nh, hd)
    y = y + xh.to(F32) * d_skip[None, None, :, None]
    return y[:, :s].to(BF16), h


def ssd_decode_step(xh, dt, a_log, b_in, c_in, d_skip, h):
    """One-token SSD update.  xh: (B, NH, HD); dt: (B, NH); b/c: (B, NS)."""
    a = torch.exp(-torch.exp(a_log.to(F32))[None] * dt)  # (B, NH)
    xdt = xh.to(F32) * dt[..., None]
    h_new = a[..., None, None] * h + torch.einsum("bhd,bs->bhds", xdt, b_in.to(F32))
    y = torch.einsum("bhds,bs->bhd", h_new, c_in.to(F32))
    y = y + xh.to(F32) * d_skip[None, :, None]
    return y.to(BF16), h_new


def causal_conv1d(x, w, b=None, state=None):
    """Depthwise causal conv, kernel k.  x: (B, S, C); w: (C, k).

    With ``state`` (B, k-1, C) performs streaming (decode) mode on S=1.
    Returns (y, new_state).
    """
    k = w.shape[1]
    if state is None:
        xp = sh.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    windows = torch.stack([xp[:, i: i + x.shape[1]] for i in range(k)], dim=-1)
    y = torch.einsum("bsck,ck->bsc", windows, w.to(x.dtype))
    if b is not None:
        y = y + b
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return F.silu(y), new_state
