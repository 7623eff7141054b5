"""Plain reference of the Mamba2 language model as the port trains it.

Float32 PyTorch with no kernel, cache or batching trick: the embedding,
``n_layers`` pre-norm Mamba2 blocks (separate z / x / B / C / dt
projections, a depthwise causal convolution of x, B and C with no bias,
SiLU on x alone, the chunked SSD scan, ``D`` skip, gated RMSNorm, the
output projection), a final RMSNorm and the tied unembedding, with the
next-token cross-entropy over sequence chunks of ``LOSS_CHUNK``.  The
departures from the published Mamba2 block (one fused input projection,
SiLU on B and C, a conv bias) are the port's, and the reference follows
the port, since it judges the port's output.

Every weight matmul runs on the SC substrate the traffic mix names:

* ``exact``: ``x @ w``;
* ``pallas_moment``: the moment law of the paper's stochastic MUL on the
  10-bit operand grid, ``(x.w + z.sqrt(max(|x|.|w| - x^2.w^2, 0) / nbit))
  . scale_x . scale_w`` on signed probabilities, with its standard
  normal noise ``z`` drawn from the call's Threefry key (``rng.py``);
  its gradient is the exact product's (straight-through).

The key chain is the system's contract: step key ``fold_in(PRNGKey(seed),
step)``, layer ``i`` ``fold_in(step, i)``, each SSM layer's rows keyed
by their SSD chunk ``fold_in(layer, t // ssm_chunk)`` and then by their
site's salt; loss chunk ``i`` ``fold_in(step, i)`` then the unembed's
salt, one key for the chunk's rows.
"""

from __future__ import annotations

import math

import torch

from perfbench.ref import rng

LOSS_CHUNK = 1024
EPS = 1e-6
SALT = {"wz": 47, "wx": 53, "wB": 59, "wC": 61, "wdt": 67, "out": 3,
        "unembed": 71}
NOISE_TILE = 128  # the moment kernel's noise rows are padded to it


def param_shapes(c: dict) -> dict:
    """``{path: (shape, init)}`` of the model's weights; ``init`` is
    ``normal`` (0.02 N(0, 1)), ``scaled`` (N(0, 1) / sqrt(fan-in)),
    ``zeros`` or ``ones``.  Layers are stacked on a leading axis."""
    d, n, L, k = c["d_model"], c["ssm_state"], c["n_layers"], c["ssm_conv"]
    di = c["ssm_expand"] * d
    h = di // c["ssm_headdim"]
    out = {"embed.table": ((c["vocab"], d), "normal"),
           "final_norm": ((d,), "ones"),
           "blocks.ln1": ((L, d), "ones")}
    layer = {"wz": ((d, di), "scaled"), "wx": ((d, di), "scaled"),
             "wB": ((d, n), "scaled"), "wC": ((d, n), "scaled"),
             "wdt": ((d, h), "scaled"), "conv_x": ((k, di), "scaled"),
             "conv_B": ((k, n), "scaled"), "conv_C": ((k, n), "scaled"),
             "A_log": ((h,), "zeros"), "D": ((h,), "ones"),
             "dt_bias": ((h,), "zeros"), "norm": ((di,), "ones"),
             "out": ((di, d), "scaled")}
    for name, (shape, init) in layer.items():
        out["blocks.ssm." + name] = ((L,) + shape, init)
    if not c["tie_embeddings"]:
        out["unembed"] = ((d, c["vocab"]), "scaled")
    return out


def matmul_params(c: dict) -> int:
    """Parameters that enter a matmul: per layer the z / x / B / C / dt
    projections and the output projection, then the unembedding once
    (tied or not); the embedding lookup is no matmul."""
    d, n = c["d_model"], c["ssm_state"]
    di = c["ssm_expand"] * d
    layer = d * (2 * di + 2 * n + di // c["ssm_headdim"]) + di * d
    return c["n_layers"] * layer + d * c["vocab"]


# --------------------------------------------------------------------------
# The SC substrate
# --------------------------------------------------------------------------


def encode(v, rows: bool, bits: int):
    """Signed probabilities on the ``bits``-bit grid and the max-abs
    scale (per row, or of the whole tensor)."""
    a = v.abs()
    scale = torch.clamp_min(a.amax(1, keepdim=True) if rows else a.amax(),
                            1e-30)
    levels = 1 << bits
    p = torch.clamp(torch.round(a / scale * levels), 0, levels - 1) / levels
    return torch.sign(v) * p, scale


def moment_law(x, w, noise, nbit: int, bits: int, rows: bool):
    xs, sx = encode(x, rows, bits)
    ws, sw = encode(w, False, bits)
    mean = xs @ ws
    var = torch.clamp_min(xs.abs() @ ws.abs() - (xs * xs) @ (ws * ws), 0.0)
    return (mean + noise * torch.sqrt(var * (1.0 / nbit))) * (sx * sw)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, noise, nbit, bits, rows):
        ctx.save_for_backward(x, w)
        return moment_law(x, w, noise, nbit, bits, rows)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w.T, x.T @ g, None, None, None, None


def sc_matmul(x, w, sub: dict, noise=None):
    """(M, K) @ (K, N) on the substrate ``sub`` (``backend``, ``nbit``,
    ``bits``); ``noise`` (M, N) for the moment law, and per-row scales
    when ``sub["rows"]``."""
    if sub["backend"] == "exact":
        return x @ w
    if sub["backend"] != "pallas_moment":
        raise ValueError(f"no reference of the {sub['backend']!r} substrate")
    return _StraightThrough.apply(x, w, noise, sub["nbit"], sub["bits"],
                                  sub["rows"])


def call_noise(key, m: int, n: int):
    """Noise of a one-key call: the (m, n) corner of a draw whose rows
    are padded to a multiple of ``min(NOISE_TILE, n)`` columns."""
    tile = max(1, min(NOISE_TILE, n))
    n_pad = -(-n // tile) * tile
    return rng.normal(key, (m, n_pad))[:, :n]


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------


def rms_norm(x, weight):
    """In float32, the result rounded to ``x``'s dtype before the
    weight."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + EPS)).to(x.dtype) * weight


def causal_conv(x, w):
    """Depthwise causal convolution over the sequence: x (b, s, c),
    w (k, c)."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + s] * w[i] for i in range(k))


def segsum(a):
    """``out[..., l, j] = a[j+1] + ... + a[l]`` for ``j <= l``, else
    -inf: the log-decay between positions of one chunk."""
    L = a.shape[-1]
    x = a[..., None].expand(*a.shape, L)  # x[..., l, j] = a[l]
    low = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device), -1)
    s = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    keep = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, -math.inf)


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD scan: ``H_t = exp(dt_t A) H_{t-1} + dt_t B_t x_t``,
    ``y_t = C_t H_t``, in chunks of ``chunk`` positions (the quadratic
    form inside a chunk, the state carried between chunks).
    x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"sequence {s} is no multiple of the chunk {L}")
    nc = s // L
    X = (x * dt[..., None]).reshape(b, nc, L, h, p)
    a = (dt * A).reshape(b, nc, L, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    acs = torch.cumsum(a, dim=-1)
    Bc, Cc = B.reshape(b, nc, L, n), C.reshape(b, nc, L, n)
    cb = torch.einsum("bcln,bcjn->bclj", Cc, Bc)
    decay = torch.exp(segsum(a))  # (b, h, c, l, j)
    y = torch.einsum("bclj,bhclj,bcjhp->bclhp", cb, decay, X)
    to_end = torch.exp(acs[..., -1:] - acs)  # (b, h, c, l)
    S = torch.einsum("bcln,bhcl,bclhp->bchnp", Bc, to_end, X)
    whole = torch.exp(acs[..., -1])  # (b, h, c)
    H = torch.zeros(b, h, n, p, dtype=x.dtype, device=x.device)
    before = []
    for c in range(nc):
        before.append(H)
        H = whole[:, :, c, None, None] * H + S[:, c]
    y = y + torch.einsum("bcln,bchnp,bhcl->bclhp", Cc,
                         torch.stack(before, 1), torch.exp(acs))
    return y.reshape(b, s, h, p)


def ssm_block(x, p: dict, c: dict, sub: dict, key):
    """One Mamba2 block on the normed residual x (b, s, d); ``key`` the
    layer's (2,) key or None."""
    b, s, d = x.shape
    di = c["ssm_expand"] * d
    h, hp = di // c["ssm_headdim"], c["ssm_headdim"]
    chunk_of = torch.arange(s, device=x.device) // c["ssm_chunk"]
    nc = -(-s // c["ssm_chunk"])
    ck = None if key is None else rng.fold_in(
        key, torch.arange(nc, device=x.device))
    rows = x.reshape(b * s, d)
    sub = dict(sub, rows=True)

    def proj(name, inp):
        noise = None
        if ck is not None:
            n_out = p[name].shape[-1]
            per_chunk = rng.normal_rows(rng.fold_in(ck, SALT[name]), n_out)
            noise = per_chunk[chunk_of].repeat(b, 1)
        y = sc_matmul(inp.reshape(b * s, -1), p[name], sub, noise)
        return y.reshape(b, s, -1)

    z, xin = proj("wz", rows), proj("wx", rows)
    B, C = proj("wB", rows), proj("wC", rows)
    dt = torch.logaddexp(proj("wdt", rows) + p["dt_bias"],
                         torch.zeros((), device=x.device))
    A = -torch.exp(p["A_log"])
    xin = torch.nn.functional.silu(causal_conv(xin, p["conv_x"]))
    B, C = causal_conv(B, p["conv_B"]), causal_conv(C, p["conv_C"])
    xh = xin.reshape(b, s, h, hp)
    y = ssd(xh, dt, A, B, C, c["ssm_chunk"]) + p["D"][:, None] * xh
    y = y.reshape(b, s, di) * torch.nn.functional.silu(z)
    return proj("out", rms_norm(y, p["norm"]))


def layer_params(params: dict, i: int) -> dict:
    pre = "blocks.ssm."
    return {k[len(pre):]: v[i] for k, v in params.items()
            if k.startswith(pre)}


def unembed_weight(params: dict, c: dict):
    """The unembedding (d_model, vocab): the table's transpose when tied."""
    return (params["embed.table"].T if c["tie_embeddings"]
            else params["unembed"])


def loss(params: dict, batch: dict, c: dict, sub: dict, key, probe=None):
    """Mean next-token cross-entropy of ``batch`` (``inputs``, ``labels``
    (b, s)); ``key`` the step's (2,) key or None.  ``probe(x, logits)``,
    if given, sees the first loss chunk's unembed call."""
    tokens = batch["inputs"].long()
    x = params["embed.table"][tokens]
    b, s, d = x.shape
    for i in range(c["n_layers"]):
        lk = None if key is None else rng.fold_in(key, i)
        xn = rms_norm(x, params["blocks.ln1"][i])
        x = x + ssm_block(xn, layer_params(params, i), c, sub, lk)
    x = rms_norm(x, params["final_norm"])
    w = unembed_weight(params, c)
    cs = min(LOSS_CHUNK, s)
    if s % cs:
        cs = s
    labels = batch["labels"].long()
    total = torch.zeros((), device=x.device)
    for i in range(s // cs):
        sl = slice(i * cs, (i + 1) * cs)
        xi = x[:, sl].reshape(b * cs, d)
        noise = None
        if key is not None:
            uk = rng.fold_in(rng.fold_in(key, i), SALT["unembed"])
            noise = call_noise(uk, b * cs, w.shape[1])
        logits = sc_matmul(xi, w, dict(sub, rows=False), noise)
        if probe is not None and i == 0:
            probe(xi, logits)
        logp = torch.log_softmax(logits, dim=-1)
        total = total - logp.gather(1, labels[:, sl].reshape(-1, 1)).sum()
    return total / (b * s)
