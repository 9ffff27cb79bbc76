"""Whisper encoder attention kernels: non-causal MHA with a static valid-key
length, in the four algorithms of `enc_attention(algo=...)`.

Counterpart of `audio_llama_tpu/ops/enc_attention.py`. Each TPU kernel has a
hand-written CUDA kernel and a plain PyTorch version that repeats its
arithmetic. The three bf16 algorithms are three softmax modes of one Hopper
kernel on wgmma and TMA (`enc_kernel` in csrc/enc_attention.cu, on the
attention block of csrc/sm90.cuh):

  algo='v3', softmax='safe'    `_kernel_v3`   -> the online mode (running
      true max);
  algo='bounded', or 'v3' with softmax='bounded'
                               `_kernel_v2` (and `_kernel_v3`'s bounded
      mode, the same function in another layout) -> the bounded mode (the
      fixed Cauchy-Schwarz shift);
  algo='twopass'               `_kernel`      -> the twopass mode (the true
      row max from a pass over K, then exp and PV);
  algo='v3q'                   `_kernel_v3q`  -> csrc/enc_attention_v3q.cu
      (int8 QK and int8 PV on the tensor cores, `mma.sync` s8).

Contract, as in the JAX package: q/k/v [B, T, H, hd]; keys at index >=
valid_len are masked; padded QUERY rows are unspecified; q is scaled in its
own dtype before the bf16 kernels (enc_attention.py:315); P is rounded to the
value dtype before PV and the denominator is summed from that rounded P.
v3q quantizes q/k/v outside its kernel, as the JAX wrapper does
(`v3q_quantize`). `block_q` and `chunk_k` choose TPU tiles and do not change
the function, so the port does not take them. Each kernel has its own launch
counter.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

NEG = -1e9
V3Q_MASK = -(2 ** 30)  # the int32 score of a masked key (enc_attention.py:209)
ALGOS = ("v3", "v3q", "bounded", "twopass")
launches = 0  # v3 (softmax='safe') kernel launches through `enc_attention`
launches_v3q = 0
launches_bounded = 0
launches_twopass = 0
# the wgmma kernel's modes -> their kind in `al_sm90_kernel_info`
SM90_KINDS = {"enc_attention": 7, "enc_attention_bounded": 8, "enc_attention_twopass": 9,
              "enc_attention_twopass_bf16": 10}


def key_tile(hd: int) -> int:
    """Keys a tile of the wgmma kernel at head_dim hd (csrc/enc_attention.cu
    `kBK`): 128, or 64 at hd 128. The keys past valid_len are masked on the
    last tile that holds a valid key; later tiles are not loaded."""
    return 64 if hd == 128 else 128


def sm90_kernel_info(name: str, hd: int = 64) -> dict:
    """Registers per thread, local (spilled) bytes, dynamic shared memory and
    resident blocks per SM of the wgmma kernel's mode `name` (one of
    SM90_KINDS) at head_dim hd, from the CUDA runtime."""
    import ctypes

    out = (ctypes.c_int * 4)()
    fn = _cuda.library().al_sm90_kernel_info
    _cuda.check(fn(SM90_KINDS[name], hd, ctypes.cast(out, ctypes.c_void_p)), f"{name} info")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2], blocks_per_sm=out[3])


def _scores(qs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 [B, H, Tq, Tk]."""
    return torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P [B, H, Tq, Tk] (f32 values) @ V [B, Tk, H, hd] -> f32 [B, H, Tq, hd]."""
    return torch.einsum("bhqk,bkhd->bhqd", p, v.float())


def _guarded(o: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    """where(l > 0, o / l, 0) -> [B, T, H, hd] in dtype."""
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return o.permute(0, 2, 1, 3).to(dtype)


def enc_attention_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """v3 'safe': the true row max. qs pre-scaled; all [B, T, H, hd]."""
    T = k.shape[1]
    s = _scores(qs, k)
    if valid_len < T:
        s[..., valid_len:] = NEG
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(v.dtype).float()
    return _guarded(_pv(p, v), p.sum(dim=-1, keepdim=True), qs.dtype)


def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """max_j ||k_j|| in f32 per (batch, head), over every row of the padded
    timeline (enc_attention.py:404-406) -> [B, H]."""
    return k.float().square().sum(dim=-1).amax(dim=1).sqrt()


def enc_attention_bounded_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kn: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """`_kernel_v2`: softmax shifted by the Cauchy-Schwarz bound ||q_i|| kn
    instead of the row max: no max pass, no rescale. A row whose exp all
    underflows returns 0 (the TPU kernel's failure on outlier keys, kept:
    CLAUDE.md softmax policy). qs pre-scaled; kn [B, H] from `key_norm_max`."""
    T = k.shape[1]
    s = _scores(qs, k)
    qn = qs.float().square().sum(dim=-1).sqrt()  # [B, T, H]
    bound = qn.permute(0, 2, 1)[..., None] * kn[:, :, None, None]
    p = torch.exp(s - bound)
    if valid_len < T:
        p[..., valid_len:] = 0.0
    p = p.to(v.dtype).float()
    return _guarded(_pv(p, v), p.sum(dim=-1, keepdim=True), qs.dtype)


def enc_attention_twopass_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int,
    exp_dtype=torch.float32,
) -> torch.Tensor:
    """`_kernel`: padded keys biased by -1e9, the true row max, p =
    exp((s - m) in exp_dtype) rounded to the value dtype, o / l unguarded."""
    T = k.shape[1]
    s = _scores(qs, k)
    if valid_len < T:
        s[..., valid_len:] += NEG
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m).to(exp_dtype)).to(v.dtype).float()
    o = _pv(p, v) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).to(qs.dtype)


def v3q_quantize(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """The v3q wrapper's quantization (enc_attention.py:363-378), q unscaled:
      q: per-(b, t, h) row scales sq = max|q| / 127;
      k: mean-subtracted over the whole padded timeline, one scale sk per
         (b, h) (padded rows count: they are not zero);
      v: per-(b, h, channel) scales sv over every row;
      c = sq * sk * scale, the per-row logit scale.
    -> (q_i8 [B, T, H, hd], k_i8 [B, T, H, hd], vt_i8 [B, H, hd, T] (V
    transposed, the kernel's PV operand layout), c [B, T, H] f32, sv
    [B, H, hd] f32). The divisions by constants (127, T) multiply by the f32
    reciprocal, as XLA compiles the JAX wrapper's; the divisions by scales
    divide."""
    T = q.shape[1]
    r127 = 1.0 / torch.tensor(127.0)  # f32: XLA folds x / 127 into x * (1/127)
    qf = q.float()
    sq = (qf.abs().amax(dim=-1) * r127.item()).clamp(min=1e-8)
    q_i8 = torch.round(qf / sq[..., None]).to(torch.int8)
    kf = k.float()
    kc = kf - kf.sum(dim=1, keepdim=True) * (1.0 / torch.tensor(float(T))).item()
    sk = (kc.abs().amax(dim=(1, 3)) * r127.item()).clamp(min=1e-8)  # [B, H]
    k_i8 = torch.round(kc / sk[:, None, :, None]).to(torch.int8)
    vf = v.float()
    sv = (vf.abs().amax(dim=1) * r127.item()).clamp(min=1e-8)  # [B, H, hd]
    vt_i8 = torch.round(vf / sv[:, None]).to(torch.int8).permute(0, 2, 3, 1).contiguous()
    c = sq * sk[:, None, :] * torch.tensor(scale, dtype=torch.float32, device=q.device)
    return q_i8, k_i8, vt_i8, c, sv


def enc_attention_v3q_plain(
    q_i8: torch.Tensor, k_i8: torch.Tensor, vt_i8: torch.Tensor, c: torch.Tensor,
    sv: torch.Tensor, valid_len: int, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """`_kernel_v3q`: the row max on the raw int32 scores over the valid
    keys, pq = round(127 exp((s - m) c)) in [0, 127], out = (pq @ V_i8) sv /
    sum(pq), 0 where the sum is 0. Integer products are exact: QK in f32
    (|s| <= 127^2 hd < 2^24), PV in f64 (up to 127^2 T), rounded to f32 as
    the TPU's int32 accumulator converts."""
    T = k_i8.shape[1]
    s = _scores(q_i8, k_i8)  # exact integers
    valid = torch.arange(T, device=s.device) < valid_len
    s = torch.where(valid, s, float(V3Q_MASK))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m) * c.permute(0, 2, 1)[..., None])
    p = torch.where(valid, p, 0.0)
    pq = torch.round(p * 127.0)
    num = torch.einsum("bhqk,bhdk->bhqd", pq.double(), vt_i8.double()).float()
    den = pq.double().sum(dim=-1, keepdim=True).float()
    num = num * sv[:, :, None, :]
    return _guarded(num, den, out_dtype)


def _check_kernel_args(name, qs, k, v, valid_len, min_valid=0):
    _cuda.require_cuda(name, qs, k, v)
    B, T, H, hd = qs.shape
    _cuda.require_shape(name, k, qs.shape)
    _cuda.require_shape(name, v, qs.shape)
    if not min_valid <= valid_len <= T:
        raise ValueError(f"{name}: valid_len {valid_len} outside [{min_valid}, {T}]")
    for t in (qs, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or not _cuda.aligned16(t):
            raise ValueError(f"{name}: rows must be contiguous 16-byte vectors")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"{name}: head_dim {hd} not in (16, 32, 64, 128)")


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def enc_attention_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """Launch the kernel's online mode (v3). qs/k/v may be strided views ([B,
    T, H, hd] over a [B, T, H*hd] projection output, or a head-major [B, H,
    T, hd] tensor transposed); the last dim must be contiguous and the other
    strides and the bases 16-byte multiples (TMA)."""
    global launches
    name = "enc_attention"
    _check_kernel_args(name, qs, k, v, valid_len)
    B, T, H, hd = qs.shape
    o = torch.empty((B, T, H, hd), dtype=qs.dtype, device=qs.device)
    err = _cuda.library().al_enc_attention(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, T, H, hd, int(valid_len), *_strides(qs, k, v, o), _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    launches += 1
    return o


def enc_attention_bounded_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kn: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """Launch the kernel's bounded mode (layouts as `enc_attention_cuda`; kn
    [B, H] f32)."""
    global launches_bounded
    name = "enc_attention_bounded"
    _check_kernel_args(name, qs, k, v, valid_len)
    B, T, H, hd = qs.shape
    if kn.dtype != torch.float32 or tuple(kn.shape) != (B, H) or kn.device != qs.device:
        raise ValueError(f"{name}: kn must be f32 [{B}, {H}] on {qs.device}")
    kn = kn.contiguous()
    o = torch.empty((B, T, H, hd), dtype=qs.dtype, device=qs.device)
    err = _cuda.library().al_enc_attention_bounded(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), kn.data_ptr(), o.data_ptr(),
        B, T, H, hd, int(valid_len), *_strides(qs, k, v, o), _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    launches_bounded += 1
    return o


def enc_attention_twopass_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int,
    exp_dtype=torch.float32,
) -> torch.Tensor:
    """Launch the kernel's twopass mode (layouts as `enc_attention_cuda`); at
    least one valid key."""
    global launches_twopass
    name = "enc_attention_twopass"
    _check_kernel_args(name, qs, k, v, valid_len, min_valid=1)
    if exp_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: exp_dtype {exp_dtype} not f32 or bf16")
    B, T, H, hd = qs.shape
    o = torch.empty((B, T, H, hd), dtype=qs.dtype, device=qs.device)
    err = _cuda.library().al_enc_attention_twopass(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, T, H, hd, int(valid_len), int(exp_dtype == torch.bfloat16),
        *_strides(qs, k, v, o), _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    launches_twopass += 1
    return o


def enc_attention_v3q_cuda(
    q_i8: torch.Tensor, k_i8: torch.Tensor, vt_i8: torch.Tensor, c: torch.Tensor,
    sv: torch.Tensor, valid_len: int, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Launch the int8 kernel on `v3q_quantize`'s tensors (contiguous; hd 64,
    T a multiple of 64) -> [B, T, H, 64] bf16."""
    global launches_v3q
    name = "enc_attention_v3q"
    _cuda.require_cuda(name, q_i8, k_i8, vt_i8, c, sv)
    B, T, H, hd = q_i8.shape
    if hd != 64 or T % 64:
        raise ValueError(f"{name}: the kernel takes hd 64 and T % 64 == 0, got hd {hd}, T {T}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel writes bf16, not {out_dtype}")
    for t, shape, dtype in ((q_i8, (B, T, H, hd), torch.int8), (k_i8, (B, T, H, hd), torch.int8),
                            (vt_i8, (B, H, hd, T), torch.int8), (c, (B, T, H), torch.float32),
                            (sv, (B, H, hd), torch.float32)):
        _cuda.require_shape(name, t, shape)
        if t.dtype != dtype or not t.is_contiguous() or not _cuda.aligned16(t):
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {dtype} tensor")
    if not 0 <= valid_len <= T:
        raise ValueError(f"{name}: valid_len {valid_len} outside [0, {T}]")
    o = torch.empty((B, T, H, hd), dtype=out_dtype, device=q_i8.device)
    err = _cuda.library().al_enc_attention_v3q(
        q_i8.data_ptr(), k_i8.data_ptr(), vt_i8.data_ptr(), c.data_ptr(), sv.data_ptr(),
        o.data_ptr(), B, T, H, int(valid_len), _cuda.stream_handle(q_i8),
    )
    _cuda.check(err, name)
    launches_v3q += 1
    return o


def enc_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    valid_len: Optional[int] = None,
    scale: Optional[float] = None,
    algo: str = "v3",
    softmax: str = "safe",
    exp_dtype=torch.float32,
) -> torch.Tensor:
    """Non-causal self-attention, [B, T, H, hd] in and out: the kernels on
    CUDA tensors, the plain versions on CPU tensors. `algo` in ALGOS;
    `softmax` 'safe' or 'bounded' (v3 only); `exp_dtype` f32 or bf16
    (twopass only). Raises on any other combination."""
    if algo not in ALGOS:
        raise ValueError(f"enc_attention: algo {algo!r} not in {ALGOS}")
    if softmax not in ("safe", "bounded") or (softmax == "bounded" and algo != "v3"):
        raise ValueError(f"enc_attention: softmax={softmax!r} with algo={algo!r} (the bounded "
                         "shift is a mode of v3 only)")
    if exp_dtype not in (torch.float32, torch.bfloat16) or (
            exp_dtype != torch.float32 and algo != "twopass"):
        raise ValueError(f"enc_attention: exp_dtype={exp_dtype} with algo={algo!r} (a bf16 exp "
                         "is a mode of twopass only)")
    T, hd = q.shape[1], q.shape[3]
    if scale is None:
        scale = hd ** -0.5
    nvalid = T if valid_len is None else int(valid_len)
    cpu = q.device.type == "cpu"
    if algo == "v3q":
        args = (*v3q_quantize(q, k, v, scale), nvalid, q.dtype)
        return enc_attention_v3q_plain(*args) if cpu else enc_attention_v3q_cuda(*args)
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    if algo == "bounded" or softmax == "bounded":
        kn = key_norm_max(k)
        fn = enc_attention_bounded_plain if cpu else enc_attention_bounded_cuda
        return fn(qs, k, v, kn, nvalid)
    if algo == "twopass":
        fn = enc_attention_twopass_plain if cpu else enc_attention_twopass_cuda
        return fn(qs, k, v, nvalid, exp_dtype)
    return (enc_attention_plain if cpu else enc_attention_cuda)(qs, k, v, nvalid)
