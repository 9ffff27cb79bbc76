"""Causal GQA attention: forward (prefill and full-sequence) and backward.

Replaces `audio_llama_tpu/ops/causal_attention.py::_fwd_kernel` (`causal_mha`,
`softmax_mode='online'`, `tri='always'`) and the two kernels of its custom
VJP, `_dq_kernel` and `_dkv_kernel`. The forward kernel is
`csrc/causal_attention.cu`, on Hopper's wgmma and TMA (`csrc/sm90.cuh`); the
backward kernels are `csrc/causal_attention_bwd.cu`, on the same blocks, and
take T a multiple of 128 (their source notes give the bounds and the
designs). `causal_attention_plain` and `causal_attention_bwd_plain` are the
same arithmetic in PyTorch. `_CausalAttention` (a `torch.autograd.Function`)
joins them: its forward saves qs, k, v, the key bias, o and the row
statistics l and m, and its backward runs the D = rowsum(dO * O) prologue in
PyTorch (as the JAX package leaves it to XLA), then dq, then dk/dv; the bias
gets no gradient.

Contract, as in the JAX package: q [B, T, Hq, hd], k/v [B, T, Hkv, hd]; the
mask [B, T] hides padded KEYS through a -1e9 bias added before the max (never
-inf, so a fully masked row stays finite); padded QUERY rows are garbage; T
is padded to a multiple of 128 here (causal_attention.py:838-850); q is
scaled in its own dtype, outside the Function, so autograd carries the scale
and the pad slices. The forward kernel runs exp in f32 where the TPU kernel
runs it in bf16; both round P to bf16 before PV and sum the denominator from
that rounded P. The backward recomputes P in f32 from the saved m and l and
rounds P and dS to the input dtype before their products, as the TPU kernels
do.

`tri` selects the kernels' mode, as the JAX package's `tri` argument:
'always' (the causal mask; every call above) or 'never' (no mask, every key
tile contributes: one hop of the ring of sequence-parallel training,
`parallel/ring_kernel.py`, over a K/V block from an earlier shard, the
backward fed the ring's global m, l and D). Each mode of each kernel counts
its own launches.

The forward variants of `causal_mha(fwd_impl=..., softmax_mode=...)`, the
JAX package's A/B arms (its `_fwd_dispatch`, causal_attention.py:705-716),
each a plain version and a kernel here:
  fwd_impl 'blocks_cond': the forward with tri='cond', the causal mask only
      on the key tiles that reach past a query tile's first row: the same
      numbers as 'always' (the kernel gives the same bits);
  softmax_mode 'bounded' (`causal_attention_bounded_*`, tri 'always' or
      'cond'): the fixed shift c_i = ||qs_i|| * kn[b, kv head], kn the max
      key norm of the (batch, KV head) over all T keys (`key_norm_max`),
      p = exp(s - c) in f32, l summed from that f32 p, PV on bf16(p),
      o = l > 0 ? O / l : 0: rows whose exp all underflow (outlier keys)
      come out 0, the TPU kernel's kept failure;
  softmax_mode 'twopass' (`causal_attention_twopass_*`): c = the true row
      max, p = exp of a bf16 argument when v is bf16, rounded, l summed from
      the rounded p, no rescale; tri does not apply;
  fwd_impl 'dma' / 'dma2' (`causal_attention_dma_*`): the bounded
      arithmetic; dma runs the bounded kernel (TMA fetches only the valid
      key tiles in every mode, which is all that set dma apart on the TPU),
      dma2 its own (three stages, tile j+1's QK^T ahead of tile j's softmax
      and PV); these take softmax_mode 'bounded' whatever is asked
      (causal_attention.py:871-872).
Every forward kernel runs on Hopper's wgmma and TMA (`csrc/sm90.cuh`):
online in `csrc/causal_attention.cu`, bounded and twopass in
`csrc/causal_attention_fixed.cu`, dma2 in `csrc/causal_attention_dma2.cu`.
TMA reads the key bias too, so the wrappers hand it over 16-byte aligned
(`_tma_bias`).
Every variant returns its shift residual as `m` (for the bounded family that
is JAX's c, the bound), and the one backward above serves them all: it takes
any per-row shift, P = exp(s - m) / l. kn enters as an input without a
gradient, as JAX's custom VJP returns zeros for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _cuda

NEG = -1e9
TILE = 128
launches = 0  # forward kernel launches (tri='always')
launches_dq = 0  # dq kernel launches (tri='always')
launches_dkv = 0  # dk/dv kernel launches (tri='always')
launches_never = 0  # forward kernel launches, tri='never'
launches_dq_never = 0  # dq kernel launches, tri='never'
launches_dkv_never = 0  # dk/dv kernel launches, tri='never'
launches_cond = 0  # forward kernel launches, tri='cond' (fwd_impl='blocks_cond')
launches_bounded = 0  # bounded-softmax forward launches, tri='always'
launches_bounded_cond = 0  # bounded-softmax forward launches, tri='cond'
launches_twopass = 0  # two-pass forward launches
launches_dma = 0  # fwd_impl='dma' kernel launches
launches_dma2 = 0  # fwd_impl='dma2' kernel launches
BWD_TILE = 64  # the dma forwards' tile, and the backward kernels' diagonal tile
BWD_BLOCK = 128  # the backward kernels' blocks (queries or keys): T must be a multiple of it
TRI = ("always", "never")  # the backward kernels' modes
FWD_TRI = {"never": 0, "always": 1, "cond": 2}  # the forward kernel's modes
FWD_IMPLS = ("blocks", "blocks_cond", "dma", "dma2")
SOFTMAX_MODES = ("online", "twopass", "bounded")


def _causal_flag(tri: str) -> int:
    if tri not in TRI:
        raise ValueError(f"tri must be one of {TRI}; got {tri!r}")
    return int(tri == "always")


def _tri_code(tri: str) -> int:
    if tri not in FWD_TRI:
        raise ValueError(f"tri must be one of {tuple(FWD_TRI)}; got {tri!r}")
    return FWD_TRI[tri]


def _scores(qg, k, key_bias, tri):
    """[B, Hkv, G, T, T] f32 scores of pre-scaled grouped queries against the
    keys, the key bias added and, for tri 'always' or 'cond', the future
    masked."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s + key_bias[:, None, None, None, :]
    if _tri_code(tri):
        T = s.shape[-1]
        future = torch.ones(T, T, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(future, NEG)
    return s


class CausalOut(NamedTuple):
    o: torch.Tensor  # [B, T, Hq, hd]
    l: torch.Tensor  # [B*Hq, T] f32 row denominators
    m: torch.Tensor  # [B*Hq, T] f32 row maxima


def causal_attention_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    tri: str = "always",
) -> CausalOut:
    """qs pre-scaled [B, T, Hq, hd]; k/v [B, T, Hkv, hd]; key_bias [B, T] f32."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = qs.float().reshape(B, T, Hkv, G, hd)
    s = _scores(qg, k, key_bias, tri)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(v.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return _out(o, l, m, qs.dtype)


def _out(o, l, m, dtype) -> CausalOut:
    """o [B, T, Hkv, G, hd] f32 (PV as the einsums leave it), l and m [B,
    Hkv, G, T, 1] -> CausalOut with o divided by l (0 where l == 0)."""
    B, T, Hkv, G, hd = o.shape
    lq = l[..., 0].permute(0, 3, 1, 2)[..., None]  # [B, T, Hkv, G, 1]
    o = torch.where(lq > 0, o / torch.where(lq > 0, lq, 1.0), 0.0)
    return CausalOut(
        o=o.reshape(B, T, Hkv * G, hd).to(dtype),
        l=l[..., 0].reshape(B * Hkv * G, T),
        m=m[..., 0].reshape(B * Hkv * G, T),
    )


def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """kn [B, Hkv] f32: the largest key norm of each (batch, KV head) over all
    T keys (causal_attention.py:867-869): keys the mask hides and keys in any
    query's future count too. Computed without a gradient (the TPU kernel's
    VJP returns zeros for it)."""
    with torch.no_grad():
        return k.detach().float().pow(2).sum(dim=-1).amax(dim=1).sqrt()


def row_bound(qs: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
    """The bounded shift c = ||qs_i|| * kn[b, kv head] (f32 squares of the
    pre-scaled q in its own dtype) -> [B, Hkv, G, T, 1]."""
    B, T, Hq, _ = qs.shape
    Hkv = kn.shape[1]
    qn = qs.float().pow(2).sum(dim=-1).sqrt()  # [B, T, Hq]
    qn = qn.reshape(B, T, Hkv, Hq // Hkv).permute(0, 2, 3, 1)[..., None]
    return qn * kn[:, :, None, None, None]


def causal_attention_bounded_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    kn: torch.Tensor, tri: str = "always",
) -> CausalOut:
    """`_fwd_kernel` softmax='bounded' (causal_attention.py:109-143, :175-178):
    p = exp(s - c) in f32 with the key bias and the causal mask in s, l
    summed from that f32 p, PV on p rounded to v's dtype; m returns c. kn
    [B, Hkv] from `key_norm_max`; tri 'always' or 'cond' (the same numbers)."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    qg = qs.float().reshape(B, T, Hkv, Hq // Hkv, hd)
    s = _scores(qg, k, key_bias, tri)
    c = row_bound(qs, kn)
    p = torch.exp(s - c)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return _out(o, l, c.expand_as(l), qs.dtype)


def causal_attention_twopass_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
) -> CausalOut:
    """`_fwd_kernel_twopass` (causal_attention.py:188-247): c = the true row
    max of s (key bias and causal mask in), p = exp(s - c) through a bf16
    argument when v is bf16, rounded to v's dtype, l summed from the rounded
    p, no rescale; m returns c."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    qg = qs.float().reshape(B, T, Hkv, Hq // Hkv, hd)
    s = _scores(qg, k, key_bias, "always")
    c = s.amax(dim=-1, keepdim=True)
    x = s - c
    if v.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    p = torch.exp(x).to(v.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return _out(o, l, c, qs.dtype)


def causal_attention_dma_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    kn: torch.Tensor,
) -> CausalOut:
    """`_fwd_kernel_dma` and `_fwd_kernel_dma2` (causal_attention.py:250-414):
    the bounded arithmetic over the valid key chunks, bias and causal mask on
    every chunk. Only the kernels' structure (asynchronous K/V copies of the
    valid tiles: two cp.async stages, or dma2's three-deep TMA ring) sets
    them apart from the bounded mode, so this is
    `causal_attention_bounded_plain`."""
    return causal_attention_bounded_plain(qs, k, v, key_bias, kn)


def _fwd_checks(name, qs, k, v, key_bias):
    _cuda.require_cuda(name, qs, k, v, key_bias)
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} not a multiple of Hkv={Hkv}")
    _cuda.require_shape(name, k, (B, T, Hkv, hd))
    _cuda.require_shape(name, v, (B, T, Hkv, hd))
    _cuda.require_shape(name, key_bias, (B, T))
    for t in (qs, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or not _cuda.aligned16(t):
            raise ValueError(f"{name}: rows must be contiguous 16-byte vectors")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"{name}: head_dim {hd} not in (16, 32, 64, 128)")
    return B, T, Hq, Hkv, hd


def _outputs(qs):
    B, T, Hq, hd = qs.shape
    o = torch.empty((B, T, Hq, hd), dtype=qs.dtype, device=qs.device)
    l = torch.empty((B * Hq, T), dtype=torch.float32, device=qs.device)
    m = torch.empty((B * Hq, T), dtype=torch.float32, device=qs.device)
    return o, l, m


def _tma_bias(key_bias: torch.Tensor) -> torch.Tensor:
    """key_bias as the wgmma / TMA kernels read it: f32, contiguous, its base
    on a 16-byte boundary (a view that starts inside its storage may not be:
    then a copy)."""
    key_bias = key_bias.to(torch.float32).contiguous()
    return key_bias if _cuda.aligned16(key_bias) else key_bias.clone()


# the wgmma / TMA kernels -> their kind in al_sm90_kernel_info: twopass, dma2,
# online with the causal mask ('always', 'cond'), online 'never', bounded
# (blocks, blocks_cond, dma); the backward's dq and dk/dv, 'always' and 'never'
SM90_KERNELS = {"causal_attention_twopass": 0, "causal_attention_dma2": 1,
                "causal_attention": 2, "causal_attention_never": 3,
                "causal_attention_bounded": 4, "causal_attention_dq": 11,
                "causal_attention_dq_never": 12, "causal_attention_dkv": 13,
                "causal_attention_dkv_never": 14}


def sm90_kernel_info(name: str, hd: int) -> dict:
    """Registers per thread, local (spilled) bytes, dynamic shared memory and
    resident blocks per SM of the wgmma / TMA kernel `name` (one of
    SM90_KERNELS) at head_dim hd, from the CUDA runtime (cudaFuncGetAttributes
    and the occupancy calculator)."""
    import ctypes

    out = (ctypes.c_int * 4)()
    fn = _cuda.library().al_sm90_kernel_info
    _cuda.check(fn(SM90_KERNELS[name], hd, ctypes.cast(out, ctypes.c_void_p)),
                f"{name} info")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2], blocks_per_sm=out[3])


def _kn_arg(name, kn, B, Hkv, device):
    if kn.dtype != torch.float32 or tuple(kn.shape) != (B, Hkv) or kn.device != device:
        raise ValueError(f"{name}: kn must be f32 [{B}, {Hkv}] on {device}")
    return kn.contiguous()


def causal_attention_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    tri: str = "always",
) -> CausalOut:
    """Launch the kernel (same arguments as the plain version; tri 'always',
    'never' or 'cond'; any T)."""
    global launches, launches_never, launches_cond
    name = "causal_attention"
    code = _tri_code(tri)
    B, T, Hq, Hkv, hd = _fwd_checks(name, qs, k, v, key_bias)
    key_bias = _tma_bias(key_bias)
    o, l, m = _outputs(qs)
    err = _cuda.library().al_causal_attention(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        l.data_ptr(), m.data_ptr(), key_bias.data_ptr(),
        B, T, Hq, Hkv, hd,
        *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        code, _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    if tri == "always":
        launches += 1
    elif tri == "never":
        launches_never += 1
    else:
        launches_cond += 1
    return CausalOut(o, l, m)


def causal_attention_bounded_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    kn: torch.Tensor, tri: str = "always",
) -> CausalOut:
    """Launch the bounded-softmax kernel (`csrc/causal_attention_fixed.cu`;
    the plain version's arguments; tri 'always' or 'cond', one kernel)."""
    global launches_bounded, launches_bounded_cond
    name = "causal_attention_bounded"
    if tri not in ("always", "cond"):
        raise ValueError(f"{name}: tri must be 'always' or 'cond'; got {tri!r}")
    B, T, Hq, Hkv, hd = _fwd_checks(name, qs, k, v, key_bias)
    kn = _kn_arg(name, kn, B, Hkv, qs.device)
    key_bias = _tma_bias(key_bias)
    o, l, m = _outputs(qs)
    err = _cuda.library().al_causal_attention_fixed(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        key_bias.data_ptr(), kn.data_ptr(), B, T, Hq, Hkv, hd,
        *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        1, _tri_code(tri), 0, _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    if tri == "always":
        launches_bounded += 1
    else:
        launches_bounded_cond += 1
    return CausalOut(o, l, m)


def causal_attention_twopass_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
) -> CausalOut:
    """Launch the two-pass kernel (`csrc/causal_attention_fixed.cu`, through
    `al_causal_attention_fixed`; the plain version's arguments; the exp
    argument rounded to bf16, as the TPU kernel's for bf16 v)."""
    global launches_twopass
    name = "causal_attention_twopass"
    B, T, Hq, Hkv, hd = _fwd_checks(name, qs, k, v, key_bias)
    key_bias = _tma_bias(key_bias)
    o, l, m = _outputs(qs)
    err = _cuda.library().al_causal_attention_fixed(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        key_bias.data_ptr(), None, B, T, Hq, Hkv, hd,
        *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        2, 1, 1, _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    launches_twopass += 1
    return CausalOut(o, l, m)


def causal_attention_dma_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    kn: torch.Tensor, pipelined: bool = False,
) -> CausalOut:
    """Launch fwd_impl 'dma' (the bounded kernel of
    `csrc/causal_attention_fixed.cu`: a two-stage TMA ring of the valid key
    tiles) or, with `pipelined`, 'dma2' (`csrc/causal_attention_dma2.cu`: a
    three-deep TMA ring, tile j+1's QK^T in flight during tile j's softmax).
    The plain version's arguments; T a multiple of 64, as JAX's chunks."""
    global launches_dma, launches_dma2
    name = "causal_attention_dma2" if pipelined else "causal_attention_dma"
    B, T, Hq, Hkv, hd = _fwd_checks(name, qs, k, v, key_bias)
    if T % BWD_TILE:
        raise ValueError(f"{name}: T={T} not a multiple of {BWD_TILE}")
    kn = _kn_arg(name, kn, B, Hkv, qs.device)
    key_bias = _tma_bias(key_bias)
    o, l, m = _outputs(qs)
    err = _cuda.library().al_causal_attention_dma(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        key_bias.data_ptr(), kn.data_ptr(), B, T, Hq, Hkv, hd,
        *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(pipelined), _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    if pipelined:
        launches_dma2 += 1
    else:
        launches_dma += 1
    return CausalOut(o, l, m)


def variant_forward(fwd_impl: str = "blocks", softmax_mode: str = "online"):
    """(fwd_impl, softmax_mode) -> (plain, kernel), each a function of (qs,
    k, v, key_bias, kn) -> CausalOut, as the JAX package's `_fwd_dispatch`
    picks a kernel (causal_attention.py:705-716); kn is read by the bounded
    family only. dma and dma2 are bounded whatever softmax_mode says."""
    if fwd_impl not in FWD_IMPLS:
        raise ValueError(f"fwd_impl must be one of {FWD_IMPLS}; got {fwd_impl!r}")
    if softmax_mode not in SOFTMAX_MODES:
        raise ValueError(f"softmax_mode must be one of {SOFTMAX_MODES}; got {softmax_mode!r}")
    if fwd_impl in ("dma", "dma2"):
        pipelined = fwd_impl == "dma2"
        return (causal_attention_dma_plain,
                lambda qs, k, v, b, kn: causal_attention_dma_cuda(qs, k, v, b, kn, pipelined))
    tri = "cond" if fwd_impl == "blocks_cond" else "always"
    if softmax_mode == "twopass":  # tri does not apply
        return (lambda qs, k, v, b, kn: causal_attention_twopass_plain(qs, k, v, b),
                lambda qs, k, v, b, kn: causal_attention_twopass_cuda(qs, k, v, b))
    if softmax_mode == "bounded":
        return (lambda qs, k, v, b, kn: causal_attention_bounded_plain(qs, k, v, b, kn, tri),
                lambda qs, k, v, b, kn: causal_attention_bounded_cuda(qs, k, v, b, kn, tri))
    return (lambda qs, k, v, b, kn: causal_attention_plain(qs, k, v, b, tri),
            lambda qs, k, v, b, kn: causal_attention_cuda(qs, k, v, b, tri))


def attention_bwd_prologue(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32: o, do [B, T, Hq, hd] -> [B*Hq, T]."""
    B, T, Hq, _ = o.shape
    d = (do.float() * o.float()).sum(dim=-1)  # [B, T, Hq]
    return d.transpose(1, 2).reshape(B * Hq, T).contiguous()


def causal_attention_bwd_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    o: torch.Tensor, l: torch.Tensor, m: torch.Tensor, do: torch.Tensor,
    tri: str = "always",
):
    """The backward of `causal_attention_plain` from its saved residuals ->
    (dq [B, T, Hq, hd], dk, dv [B, T, Hkv, hd]) in the inputs' dtypes: P
    recomputed as exp(s - m) / l (0 where l == 0), dS = P (dP - D), P and dS
    rounded to the input dtype before their products, f32 sums, dk and dv
    summed over the G query heads of each group. For a ring hop
    (tri='never') o, l and m are the whole row's, merged over the ring."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    d = attention_bwd_prologue(o, do).reshape(B, Hkv, G, T, 1)
    qg = qs.float().reshape(B, T, Hkv, G, hd)
    dog = do.float().reshape(B, T, Hkv, G, hd)
    s = _scores(qg, k, key_bias, tri)
    lq = l.reshape(B, Hkv, G, T, 1)
    inv_l = torch.where(lq > 0, 1.0 / torch.where(lq > 0, lq, 1.0), 0.0)
    p = torch.exp(s - m.reshape(B, Hkv, G, T, 1)) * inv_l
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - d)).to(qs.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(B, T, Hq, hd)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_checks(name, qs, k, v, key_bias, l, m, do, d):
    _cuda.require_cuda(name, qs, k, v, key_bias, l, m, do, d)
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} not a multiple of Hkv={Hkv}")
    if T % BWD_BLOCK:
        raise ValueError(f"{name}: T={T} not a multiple of {BWD_BLOCK}")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"{name}: head_dim {hd} not in (16, 32, 64, 128)")
    for t, shape in ((k, (B, T, Hkv, hd)), (v, (B, T, Hkv, hd)), (do, (B, T, Hq, hd)),
                     (key_bias, (B, T)), (l, (B * Hq, T)), (m, (B * Hq, T)), (d, (B * Hq, T))):
        _cuda.require_shape(name, t, shape)
    for t in (qs, k, v, do):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
    for t in (key_bias, l, m, d):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: statistics and bias must be f32, got {t.dtype}")
    for t in (qs, k, v, do, key_bias, l, m, d):
        if not t.is_contiguous() or not _cuda.aligned16(t):
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    return B, T, Hq, Hkv, hd


def causal_attention_dq_cuda(qs, k, v, key_bias, l, m, do, d, tri="always") -> torch.Tensor:
    """Launch the dq kernel: qs, do [B, T, Hq, hd], k, v [B, T, Hkv, hd] bf16
    contiguous; key_bias [B, T], l, m, d [B*Hq, T] f32, all 16-byte aligned;
    T a multiple of BWD_BLOCK -> dq [B, T, Hq, hd]."""
    global launches_dq, launches_dq_never
    name = "causal_attention_dq"
    causal = _causal_flag(tri)
    B, T, Hq, Hkv, hd = _bwd_checks(name, qs, k, v, key_bias, l, m, do, d)
    dq = torch.empty_like(qs)
    err = _cuda.library().al_causal_attention_dq(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
        d.data_ptr(), key_bias.data_ptr(), dq.data_ptr(), B, T, Hq, Hkv, hd, causal,
        _cuda.stream_handle(qs))
    _cuda.check(err, name)
    if causal:
        launches_dq += 1
    else:
        launches_dq_never += 1
    return dq


def causal_attention_dkv_cuda(qs, k, v, key_bias, l, m, do, d, tri="always"):
    """Launch the dk/dv kernel (the dq kernel's arguments) -> (dk, dv)
    [B, T, Hkv, hd], each summed over the G query heads of its group."""
    global launches_dkv, launches_dkv_never
    name = "causal_attention_dkv"
    causal = _causal_flag(tri)
    B, T, Hq, Hkv, hd = _bwd_checks(name, qs, k, v, key_bias, l, m, do, d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _cuda.library().al_causal_attention_dkv(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
        d.data_ptr(), key_bias.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, Hq, Hkv, hd,
        causal, _cuda.stream_handle(qs))
    _cuda.check(err, name)
    if causal:
        launches_dkv += 1
    else:
        launches_dkv_never += 1
    return dk, dv


def causal_attention_bwd_cuda(qs, k, v, key_bias, o, l, m, do, tri="always"):
    """The prologue, then the two kernels (same arguments and results as
    `causal_attention_bwd_plain`)."""
    d = attention_bwd_prologue(o, do)
    dq = causal_attention_dq_cuda(qs, k, v, key_bias, l, m, do, d, tri)
    dk, dv = causal_attention_dkv_cuda(qs, k, v, key_bias, l, m, do, d, tri)
    return dq, dk, dv


class _CausalAttention(torch.autograd.Function):
    """(qs, k, v, key_bias, kn) -> (o, l, m) through the forward variant of
    (fwd_impl, softmax_mode): its kernel on CUDA tensors, its plain version
    on CPU tensors; l and m carry no gradient, nor do the bias and kn."""

    @staticmethod
    def forward(ctx, qs, k, v, key_bias, kn, fwd_impl="blocks", softmax_mode="online"):
        plain, kernel = variant_forward(fwd_impl, softmax_mode)
        run = plain if qs.device.type == "cpu" else kernel
        o, l, m = run(qs, k, v, key_bias, kn)
        ctx.save_for_backward(qs, k, v, key_bias, o, l, m)
        ctx.mark_non_differentiable(l, m)
        return o, l, m

    @staticmethod
    def backward(ctx, do, _dl, _dm):
        qs, k, v, key_bias, o, l, m = ctx.saved_tensors
        do = do.to(o.dtype).contiguous()
        if qs.device.type == "cpu":
            dq, dk, dv = causal_attention_bwd_plain(qs, k, v, key_bias, o, l, m, do)
        else:
            dq, dk, dv = causal_attention_bwd_cuda(
                qs.contiguous(), k.contiguous(), v.contiguous(), key_bias, o, l, m, do)
        return dq, dk, dv, None, None, None, None


def _pick(n: int, cands) -> int:
    for c in cands:
        if n % c == 0:
            return c
    return n


def causal_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    *,
    block_q: int = 0,
    chunk_k: int = 0,
    fwd_impl: str = "blocks",
    softmax_mode: str = "online",
) -> CausalOut:
    """Pad T to the 128 tile, scale q, build the key bias (and, for the
    bounded family, kn), then run the forward variant's kernel (CUDA tensors)
    or plain version (CPU tensors) through `_CausalAttention`, so the
    backward kernels (or the plain backward) serve autograd. Returns o [B, T,
    Hq, hd] and l, m [B*Hq, T_padded]; m is the variant's shift: the row max
    for 'online' and 'twopass', the bound c for 'bounded', 'dma', 'dma2'.

    block_q and chunk_k (0: the largest of 512, 256, 128 dividing the padded
    T) are checked as the JAX package needs them, dividing the padded T; the
    port's kernels keep their own tiles, so its results do not depend on
    them, and they agree with JAX's at any choice within the stated bars,
    not bit for bit (JAX's f32 sums follow its tiles)."""
    B, T, Hq, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    variant_forward(fwd_impl, softmax_mode)  # refuses an unknown name
    if fwd_impl in ("dma", "dma2"):
        softmax_mode = "bounded"  # the DMA variants have no online path (as JAX's)
    pad = (-T) % TILE
    Tp = T + pad
    bq = block_q or _pick(Tp, (512, 256, 128))
    ck = chunk_k or _pick(Tp, (512, 256, 128))
    for label, n in (("block_q", bq), ("chunk_k", ck)):
        if n <= 0 or Tp % n:
            raise ValueError(f"{label}={n} must be positive and divide the padded T={Tp}")
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.int32, device=q.device)
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        mask = F.pad(mask.to(torch.int32), (0, pad))  # pad keys are invisible
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    key_bias = torch.where(mask != 0, zero, NEG)
    kn = key_norm_max(k) if softmax_mode == "bounded" else None
    out = CausalOut(*_CausalAttention.apply(qs, k, v, key_bias, kn, fwd_impl, softmax_mode))
    return out._replace(o=out.o[:, :T]) if pad else out


def causal_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    *,
    block_q: int = 0,
    chunk_k: int = 0,
    fwd_impl: str = "blocks",
    softmax_mode: str = "online",
) -> torch.Tensor:
    """Causal GQA self-attention, [B, T, Hq, hd] in and out, differentiable.
    fwd_impl in ('blocks', 'blocks_cond', 'dma', 'dma2') and softmax_mode in
    ('online', 'twopass', 'bounded') pick the forward variant, as the JAX
    package's `causal_mha` (`causal_attention_fwd`)."""
    return causal_attention_fwd(q, k, v, mask, scale, block_q=block_q, chunk_k=chunk_k,
                                fwd_impl=fwd_impl, softmax_mode=softmax_mode).o
