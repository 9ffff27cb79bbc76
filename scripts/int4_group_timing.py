"""Time the port's int4 kernels on the card at the int4 path's shapes
(Llama-3.2-3B, 28 layers: decode q|k|v at M 4, whole K and K-split 768;
prefill gate|up at M 6104 as two planes and as one row; the fused MLP at M
4) for each scale group given, by CUDA events over 20 calls (5 for the
prefill) after 3 warm-up calls, the layer rotating. Prints one JSON line
{case: ms}. It imports `audio_llama_tpu_torch` from the current directory,
so two checkouts of the repo can be timed in turns on one card:

    cd <checkout>; python scripts/int4_group_timing.py 128 32 64

(an older checkout whose kernels take group 128 only: `128` alone).
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from audio_llama_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from audio_llama_tpu_torch.ops import mlp_int4 as mlp4  # noqa: E402

dev = torch.device("cuda")
groups = [int(g) for g in sys.argv[1:]] or [128]
L, D, Fd, Nqkv, B, M_pre = 28, 3072, 8192, 5120, 4, 6104
gen = torch.Generator(device=dev).manual_seed(0)


def rb(*s):
    return torch.randint(-128, 128, s, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)


def rs(*s):
    return torch.rand(s, generator=gen, device=dev) * 0.02 + 0.002


def ms(fn, iters=20):
    for i in range(3):
        fn(i)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


out = {}
x4, xp = torch.randn((B, D), generator=gen, device=dev).bfloat16(), \
    torch.randn((M_pre, D), generator=gen, device=dev).bfloat16()
for g in groups:
    kw = {} if g == 128 else {"group": g}
    p, s = rb(L, D, Nqkv // 2), rs(L, D // g, Nqkv)
    out[f"g{g} decode q|k|v"] = ms(lambda i: i4.int4_matmul_stacked_cuda(x4, p, s, i % L, **kw))
    out[f"g{g} decode q|k|v bk768"] = ms(lambda i: i4.int4_matmul_stacked_cuda(
        x4, p, s, i % L, block_k=768, **kw))
    p, s = rb(L, D, Fd), rs(L, D // g, 2 * Fd)
    out[f"g{g} prefill gate|up planes"] = ms(lambda i: i4.int4_matmul_stacked_cuda(
        xp, p, s, i % L, return_planes=True, **kw), iters=5)
    out[f"g{g} prefill gate|up row"] = ms(lambda i: i4.int4_matmul_stacked_cuda(
        xp, p, s, i % L, **kw), iters=5)
    out[f"g{g} prefill gate|up row bk768"] = ms(lambda i: i4.int4_matmul_stacked_cuda(
        xp, p, s, i % L, block_k=768, **kw), iters=5)
    dn, dns = rb(L, Fd, D // 2), rs(L, Fd // g, D)
    chunk = mlp4.kernel_chunk(Fd, D // 2, g)
    out[f"g{g} mlp"] = ms(lambda i: mlp4.mlp_int4_stacked_cuda(
        x4, p, s, dn, dns, i % L, chunk=chunk, **kw))
    del p, s, dn, dns
print(json.dumps(out))
