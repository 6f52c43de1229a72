"""Plain PyTorch forward of a Mistral or Mixtral configuration in float32.

It follows the published models (``MistralForCausalLM``,
``MixtralForCausalLM``): RMSNorm, the half-split rotary embedding with
``rope_theta``, grouped-query attention that sees the last
``sliding_window`` positions (itself included) or every earlier one, a
SiLU-gated MLP, or for a mixture the softmax over the router's top-k
logits weighting those experts' SiLU-gated MLPs, a final RMSNorm and an
untied unembedding. There is no cache, no batching of rows and no kernel:
every sequence is one causal pass over its whole length, layer after
layer, with the projections over all sequences' rows together (in row
blocks) and the attention per sequence in blocks of queries, each over
the keys its window can see. TF32 is off, so every product is a float32
product.

The weights are the benchmark's tree (``benchmark/weights.py``): bf16
tensors, or int8 codes with f32 group scales, which the reference
dequantizes itself, a layer (and an expert) at a time, so that it fits
beside them on the card.

``precision`` selects the control: "fp8" rounds every projection's weight
(per tensor) and input (per row) to float8 e4m3, "int4" re-quantizes
every projection weight to symmetric int4 over 64-row groups; "f32" is
the reference itself.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import torch

PRECISIONS = ("f32", "fp8", "int4")
ROW_BLOCK = 4096
QUERY_BLOCK = 512
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def dense(leaf, *index) -> torch.Tensor:
    """The f32 matrix at ``index`` of a stacked leaf: a bf16 tensor, or
    an int8 ``(codes, scales)`` pair with one scale per group of input
    rows."""
    if isinstance(leaf, tuple):
        codes, scales = leaf[0][index], leaf[1][index]
        d_in, d_out = codes.shape
        groups = scales.shape[0]
        w = codes.float().reshape(groups, d_in // groups, d_out)
        return (w * scales[:, None, :]).reshape(d_in, d_out)
    return leaf[index].float()


def _fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    s = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _int4(w: torch.Tensor, group: int = 64) -> torch.Tensor:
    d_in, d_out = w.shape
    g = w.reshape(d_in // group, group, d_out)
    s = torch.clamp(g.abs().amax(dim=1, keepdim=True), min=1e-30) / 7.0
    return (torch.clamp(torch.round(g / s), -7, 7) * s).reshape(d_in, d_out)


class Linear:
    """One projection's weight in the chosen precision."""

    def __init__(self, w: torch.Tensor, precision: str):
        self.precision = precision
        if precision == "fp8":
            w = _fp8(w, None)
        elif precision == "int4":
            w = _int4(w)
        self.w = w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = _fp8(x, -1)
        return x @ self.w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [n, heads, D] at positions [n]
    (angles in float64, then rounded to f32)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None, :]
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """Causal GQA of one sequence: q [n, H, D], k/v [n, KV, D] ->
    [n, H * D]; query i sees keys j <= i (and j > i - window with a
    window)."""
    n, H, D = q.shape
    KV = k.shape[1]
    G = H // KV
    out = torch.empty((n, H, D), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(D)
    for q0 in range(0, n, QUERY_BLOCK):
        q1 = min(n, q0 + QUERY_BLOCK)
        k0 = max(0, q0 - window + 1) if window else 0
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        allowed = kj <= qi
        if window:
            allowed &= kj > qi - window
        qb = q[q0:q1].reshape(q1 - q0, KV, G, D)
        s = torch.einsum("qhgd,khd->hgqk", qb, k[k0:q1]) * scale
        s = s.masked_fill(~allowed, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("hgqk,khd->qhgd", p, v[k0:q1])
        out[q0:q1] = o.reshape(q1 - q0, H, D)
    return out.reshape(n, H * D)


def _mlp(h: torch.Tensor, wg: Linear, wu: Linear, wd: Linear) -> torch.Tensor:
    return wd(torch.nn.functional.silu(wg(h)) * wu(h))


def forward_logits(cfg: dict, tree: dict, seqs: Sequence[Sequence[int]],
                   score: Sequence[Sequence[int]], device,
                   precision: str = "f32", probe: Optional[dict] = None
                   ) -> List[torch.Tensor]:
    """f32 logits [len(score[i]), V] of sequence i at the positions
    ``score[i]`` (each the position whose next token is scored). For a
    mixture, ``probe`` receives ``router_margin``: per scored position
    the smallest gap, over the layers, between the router's k-th and
    (k+1)-th logits (how near its expert choice came to a tie)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    with exact_f32(), torch.no_grad():
        return _forward(cfg, tree, seqs, score, device, precision, probe)


def _forward(cfg, tree, seqs, score, device, precision, probe=None):
    H = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    kv = int(cfg["num_key_value_heads"])
    D = int(cfg.get("head_dim") or H // heads)
    L = int(cfg["num_hidden_layers"])
    eps = float(cfg.get("rms_norm_eps", 1e-5))
    theta = float(cfg.get("rope_theta", 10000.0))
    window = int(cfg.get("sliding_window") or 0)
    E = int(cfg.get("num_local_experts") or 0)
    top_k = int(cfg.get("num_experts_per_tok") or 0)
    lay = tree["layers"]

    lens = [len(s) for s in seqs]
    starts = [sum(lens[:i]) for i in range(len(lens))]
    ids = torch.tensor([t for s in seqs for t in s], device=device)
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    x = tree["embed"][ids].float()
    T = x.shape[0]
    margin = torch.full((T,), float("inf"), device=device)
    for l in range(L):
        wq, wk, wv, wo = (Linear(dense(lay[n], l), precision)
                          for n in ("wq", "wk", "wv", "wo"))
        attn = torch.empty((T, heads * D), dtype=torch.float32, device=device)
        for s0, n in zip(starts, lens):
            h = rms_norm(x[s0:s0 + n], lay["attn_norm"][l], eps)
            p = pos[s0:s0 + n]
            q = rope(wq(h).reshape(n, heads, D), p, theta)
            k = rope(wk(h).reshape(n, kv, D), p, theta)
            v = wv(h).reshape(n, kv, D)
            attn[s0:s0 + n] = attention(q, k, v, window)
        for r0 in range(0, T, ROW_BLOCK):
            x[r0:r0 + ROW_BLOCK] += wo(attn[r0:r0 + ROW_BLOCK])
        del attn, wq, wk, wv, wo
        h = rms_norm(x, lay["mlp_norm"][l], eps)
        if E:
            x += _moe(h, lay, l, E, top_k, precision, margin)
        else:
            wg, wu, wd = (Linear(dense(lay[n], l), precision)
                          for n in ("w_gate", "w_up", "w_down"))
            for r0 in range(0, T, ROW_BLOCK):
                x[r0:r0 + ROW_BLOCK] += _mlp(h[r0:r0 + ROW_BLOCK], wg, wu, wd)
            del wg, wu, wd
        del h
    head = Linear(tree["lm_head"].float(), precision)
    out, margins = [], []
    for s0, rows in zip(starts, score):
        idx = torch.tensor([s0 + r for r in rows], device=device,
                           dtype=torch.long)
        h = rms_norm(x[idx], tree["final_norm"], eps)
        out.append(head(h))
        margins.append(margin[idx])
    if probe is not None and E:
        probe["router_margin"] = margins
    return out


def _moe(h: torch.Tensor, lay: dict, l: int, E: int, top_k: int,
         precision: str, margin: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """The mixture's output for every row: the router's f32 logits, the
    top-k experts (ties to the lower id), softmax weights over those k,
    each expert's MLP over the rows routed to it."""
    router = Linear(lay["router"][l].float(), precision)
    logits = router(h)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :top_k], dim=-1)
    idx = idx[:, :top_k]
    if margin is not None and E > top_k:
        torch.minimum(margin, vals[:, top_k - 1] - vals[:, top_k], out=margin)
    out = torch.zeros_like(h)
    for e in range(E):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = (Linear(dense(lay[n], l, e), precision)
                      for n in ("w_gate", "w_up", "w_down"))
        for r0 in range(0, rows.numel(), ROW_BLOCK):
            r = rows[r0:r0 + ROW_BLOCK]
            y = _mlp(h[r], wg, wu, wd)
            out.index_add_(0, r, y * gates[r, slot[r0:r0 + ROW_BLOCK], None])
        del wg, wu, wd
    return out


def teacher_forced(requests: Sequence[Dict]):
    """The sequences and scored positions of served requests
    (``prompt_ids`` and ``ids``, the served tokens): each prompt with its
    served tokens but the last, scored at every position that produced a
    served token."""
    seqs, score = [], []
    for r in requests:
        p, s = list(r["prompt_ids"]), list(r["ids"])
        seqs.append(p + s[:-1])
        score.append(list(range(len(p) - 1, len(p) - 1 + len(s))))
    return seqs, score


def widest_gap(ref: Sequence[torch.Tensor], picks: Sequence[torch.Tensor],
               probe: Optional[dict] = None) -> Dict[str, object]:
    """Over every scored position, the gap by which the reference's
    logit of the picked token lies below its best logit: the widest (with
    its request and position), the mean, the count, and how many picks
    were not the reference's best (``flips``). With a probe's router
    margins, the margin at the widest gap and the median margin."""
    gaps = [lg.max(-1).values - lg.gather(1, pick.long()[:, None])[:, 0]
            for lg, pick in zip(ref, picks)]
    allg = torch.cat(gaps)
    i = max(range(len(gaps)), key=lambda k: float(gaps[k].max()))
    j = int(gaps[i].argmax())
    out = {"widest": float(gaps[i][j]), "at": [i, j],
           "mean": float(allg.mean()), "tokens": allg.numel(),
           "flips": int((allg > 0).sum())}
    if probe and "router_margin" in probe:
        m = probe["router_margin"]
        out["router_margin_at_widest"] = float(m[i][j])
        out["router_margin_median"] = float(torch.cat(m).median())
    return out


def nucleus(logits: torch.Tensor, temperature: float, top_p: float
            ) -> torch.Tensor:
    """The distribution a sampled request draws from at each row of f32
    ``logits`` [n, V]: the softmax of ``logits / temperature`` cut to its
    nucleus (the smallest set of most probable tokens whose mass reaches
    ``top_p``; a token is in it when the tokens more probable than it
    hold less than ``top_p``), renormalized."""
    q = torch.softmax(logits / temperature, dim=-1)
    return q * _kept(q, top_p) / (q * _kept(q, top_p)).sum(-1, keepdim=True)


def _kept(q: torch.Tensor, top_p: float) -> torch.Tensor:
    """1 where a token is in its row's nucleus, else 0 (f32, q's shape)."""
    return (_mass_above(q) < top_p).to(q.dtype)


def _mass_above(q: torch.Tensor, picks: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Per row, the mass of the tokens strictly more probable than each
    token (or than the row's ``picks``)."""
    s, order = q.sort(dim=-1, descending=True)
    before = s.cumsum(-1) - s
    # ties share the mass before the first of them
    first = torch.searchsorted(-s.contiguous(), -s.contiguous(),
                               right=False)
    above_sorted = before.gather(-1, first)
    above = torch.empty_like(q).scatter_(-1, order, above_sorted)
    if picks is None:
        return above
    return above.gather(-1, picks.long()[:, None])[:, 0]


def sampled_fit(ref: Sequence[torch.Tensor], picks: Sequence[torch.Tensor],
                temperature: Sequence[float], top_p: Sequence[float]
                ) -> Dict[str, object]:
    """How well sampled tokens fit the reference's distribution. For each
    scored position of request i, with q the softmax of the reference's
    logits over ``temperature[i]`` and p its ``top_p[i]`` nucleus: the
    excess surprise ``-log q(pick) - E_p[-log q]``, whose mean is 0 for
    tokens drawn from p and grows for tokens drawn from anything else (a
    flatter or sharper temperature, no nucleus cut, another model, an
    altered token); and whether the pick lies outside the nucleus. Gives
    the mean excess (``excess``, nats), the share of picks outside
    (``outside``) and the count (``tokens``)."""
    excess, outside = [], []
    for lg, pick, t, tp in zip(ref, picks, temperature, top_p):
        q = torch.softmax(lg / t, dim=-1)
        p = nucleus(lg, t, tp)
        surprise = -torch.log(q.clamp(min=1e-38))
        expected = (p * surprise).sum(-1)
        excess.append(surprise.gather(1, pick.long()[:, None])[:, 0]
                      - expected)
        outside.append((_mass_above(q, pick) >= tp).to(torch.float32))
    e, o = torch.cat(excess), torch.cat(outside)
    return {"excess": float(e.mean()), "outside": float(o.mean()),
            "tokens": e.numel()}


def nucleus_draw(ref: Sequence[torch.Tensor], temperature: Sequence[float],
                 top_p: Sequence[float], generator: torch.Generator
                 ) -> List[torch.Tensor]:
    """One token per scored position, drawn from each request's nucleus
    of ``ref`` (the control's picks)."""
    return [torch.multinomial(nucleus(lg, t, tp), 1, generator=generator)[:, 0]
            for lg, t, tp in zip(ref, temperature, top_p)]
