"""The port's spawn helper, and the rank side of the multi-rank tests.

`parallel.distributed.spawn` runs a function in a fresh gloo world of CPU
processes and returns each rank's result; an exception in one rank fails
the whole world. The other multi-rank test files
(`test_torch_parallel.py`, `test_torch_sp_generate.py`,
`test_torch_tp_generate.py`) spawn their worlds with the functions below:
this module imports torch and the port only, so a spawned rank does not
pay for importing JAX. The JAX references stay in the parent process.
"""

import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_llama_tpu_torch import bridge
from audio_llama_tpu_torch.config import AudioLLMConfig
from audio_llama_tpu_torch.inference import generate as t_gen
from audio_llama_tpu_torch.models import llama as t_llama
from audio_llama_tpu_torch.ops import attention as t_att
from audio_llama_tpu_torch.ops import decode_attention_db as db
from audio_llama_tpu_torch.parallel import collectives, distributed
from audio_llama_tpu_torch.parallel import mesh as t_mesh
from audio_llama_tpu_torch.parallel.seq_parallel import make_sp_encode, make_sp_generate

CFG = AudioLLMConfig.tiny()
L, B, HKV, HQ, HD = 2, 2, 2, 4, 32
SCALE = HD ** -0.5


# ---------------------------------------------------------------------------
# the spawn helper
# ---------------------------------------------------------------------------

def _collectives(rank, world):
    mesh = t_mesh.build_mesh([("dp", 2), ("tp", 2)])
    tp, dp = mesh.axis("tp"), mesh.axis("dp")
    x = torch.tensor([float(rank), 1.0])
    return {
        "coords": (dp.index, tp.index),
        "psum_tp": collectives.psum(x, tp),
        "pmax_dp": collectives.pmax(x, dp),
        "gather_tp": collectives.all_gather(x[None], tp, dim=0),
        "x_unchanged": x,
    }


def _world_sum(rank, world, tag):
    x = torch.tensor([float(tag)])
    dist.all_reduce(x)
    return float(x)


def _fails_on_rank_1(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    return rank


def test_spawn_returns_each_rank_and_runs_collectives():
    out = distributed.spawn(_collectives, 4, threads=1, timeout=120)
    for r, res in enumerate(out):
        dp, tp = res["coords"]
        assert (dp, tp) == divmod(r, 2)  # JAX's row-major device order
        partner = 2 * dp + (1 - tp)
        np.testing.assert_array_equal(res["psum_tp"].numpy(), [r + partner, 2.0])
        np.testing.assert_array_equal(res["pmax_dp"].numpy(), [2 + tp, 1.0])
        np.testing.assert_array_equal(res["gather_tp"].numpy(),
                                      [[2 * dp, 1.0], [2 * dp + 1, 1.0]])
        np.testing.assert_array_equal(res["x_unchanged"].numpy(), [r, 1.0])


def test_worlds_spawned_at_once_stay_apart():
    """Each world's store is served on a port bound before its ranks start,
    so worlds spawned together (xdist workers do) never join each other."""
    out = {}

    def run(tag):
        out[tag] = distributed.spawn(_world_sum, 2, args=(tag,), threads=1, timeout=120)

    threads = [threading.Thread(target=run, args=(tag,)) for tag in (1, 10, 100)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == {tag: [2.0 * tag] * 2 for tag in (1, 10, 100)}


def test_spawn_fails_the_world_when_a_rank_raises():
    with pytest.raises(Exception, match="rank 1 gives up"):
        distributed.spawn(_fails_on_rank_1, 2, threads=1, timeout=120)
    with pytest.raises(ValueError, match="card per rank"):
        distributed.spawn(_fails_on_rank_1, 2, backend="nccl", device="cpu")


class Spawned:
    """`distributed.spawn(*args, **kw)` started in a thread: a module's world
    runs while the module computes its JAX references. Indexing or iterating
    joins the thread and gives the world's results, or raises the world's
    error."""

    def __init__(self, *args, **kw):
        self._out, self._err = None, None
        self._thread = threading.Thread(target=self._run, args=args, kwargs=kw, daemon=True)
        self._thread.start()

    def _run(self, *args, **kw):
        try:
            self._out = distributed.spawn(*args, **kw)
        except BaseException as err:  # raised in the caller's thread on first use
            self._err = err

    def result(self) -> list:
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out

    def __getitem__(self, rank):
        return self.result()[rank]

    def __iter__(self):
        return iter(self.result())


def test_spawned_world_gives_its_results_or_its_error_on_first_use():
    world = Spawned(_world_sum, 2, args=(5,), threads=1, timeout=120)
    assert world[1] == 10.0 and list(world) == [10.0, 10.0]
    failed = Spawned(_fails_on_rank_1, 2, threads=1, timeout=120)
    with pytest.raises(Exception, match="rank 1 gives up"):
        failed[0]


# ---------------------------------------------------------------------------
# rank side of test_torch_parallel.py
# ---------------------------------------------------------------------------

def merge_case(seed):
    """A whole-slab decode case over 128 slots (the append at 83):
    (q, k, v [L, B, Hkv, 128, hd], k_new, v_new, offset, valid)."""
    rng = np.random.default_rng(seed)
    Sf, off = 128, 83
    valid = (np.arange(Sf)[None, :] <= off).astype(np.int32).repeat(B, 0)
    valid[0, 40:50] = 0
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    k, v = (rng.normal(size=(L, B, HKV, Sf, HD)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.normal(size=(B, HKV, HD)).astype(np.float32) for _ in range(2))
    return q, k, v, kn, vn, off, valid


def _merged(n, bits):
    """This rank's stats kernel (plain) over its window of merge_case,
    merged over the sp axis of n ranks."""
    mesh = t_mesh.build_mesh([("sp", n)], list(range(n)))
    if mesh.rank is None:
        return None
    q, k, v, kn, vn, off, valid = merge_case(n + bits)
    q, k, v, kn, vn, valid = (torch.from_numpy(a) for a in (q, k, v, kn, vn, valid))
    ax = mesh.axis("sp")
    Sl = k.shape[3] // n
    win = slice(ax.index * Sl, (ax.index + 1) * Sl)
    kw, vw, vt = k[..., win, :].contiguous(), v[..., win, :].contiguous(), valid[:, win]
    loc = off - ax.index * Sl
    if bits == 16:
        stats = db.decode_attention_db_stats(q, kn, vn, kw, vw, 1, loc, vt, SCALE)
    elif bits == 8:
        (ck, ks), (cv, vs) = t_llama.quantize_kv_rows(kw), t_llama.quantize_kv_rows(vw)
        (kq, ksn), (vq, vsn) = t_llama.quantize_kv_rows(kn), t_llama.quantize_kv_rows(vn)
        stats = db.decode_attention_quantized_db_stats(q, kq, vq, ck, cv, ks, vs, ksn, vsn, 1,
                                                       loc, vt, SCALE)
    else:
        ckv, ks, vs = t_llama.quantize_kv_rows4(kw, vw)
        kvn, ksn, vsn = t_llama.quantize_kv_rows4(kn, vn)
        stats = db.decode_attention_quantized4_db_stats(q, kvn, ckv, ks, vs, ksn, vsn, 1, loc,
                                                        vt, SCALE)
    return t_att.merge_partial_stats(*stats[:3], ax)


SP_VALID = ("prefix", "first slot", "all")


def sp_attention_case(seed, pattern):
    """A whole-slab f32 case for `sp_partial_attention` over 128 slots:
    (q [B, 1, Hq, hd], k, v [B, Hkv, 128, hd], valid [B, 128]). `pattern`
    (SP_VALID): slots up to 83 with a hole in row 0; slot 0 only (every
    later window all invalid); every slot."""
    rng = np.random.default_rng(seed)
    Sf = 128
    q = rng.normal(size=(B, 1, HQ, HD)).astype(np.float32)
    k, v = (rng.normal(size=(B, HKV, Sf, HD)).astype(np.float32) for _ in range(2))
    if pattern == "prefix":
        valid = (np.arange(Sf)[None, :] <= 83).astype(np.int32).repeat(B, 0)
        valid[0, 40:50] = 0
    elif pattern == "first slot":
        valid = (np.arange(Sf)[None, :] == 0).astype(np.int32).repeat(B, 0)
    else:
        valid = np.ones((B, Sf), np.int32)
    return q, k, v, valid


def _sp_attention(n, pattern):
    """`sp_partial_attention` over this rank's window of sp_attention_case
    on the sp axis of n ranks."""
    mesh = t_mesh.build_mesh([("sp", n)], list(range(n)))
    if mesh.rank is None:
        return None
    q, k, v, valid = (torch.from_numpy(a) for a in
                      sp_attention_case(n + SP_VALID.index(pattern), pattern))
    ax = mesh.axis("sp")
    Sl = k.shape[2] // n
    win = slice(ax.index * Sl, (ax.index + 1) * Sl)
    return t_att.sp_partial_attention(q, k[:, :, win], v[:, :, win], valid[:, win], SCALE, ax)


def parallel_cases(rank, world, frozen_np, audio_np):
    """The merges over 2 and 4 slabs, `sp_partial_attention` over 2 and 4
    slabs, then `make_sp_encode` on two meshes and its refusal of 3 windows
    over sp = 4."""
    out = {f"merge sp{n} kv{bits}": _merged(n, bits) for n in (2, 4) for bits in (16, 8, 4)}
    out.update({f"sp attention sp{n} {p}": _sp_attention(n, p) for n in (2, 4)
                for p in SP_VALID})
    frozen, audio = bridge.from_jax(frozen_np, "cpu"), torch.from_numpy(audio_np)
    fns = {str(axes): make_sp_encode(CFG, t_mesh.build_mesh(axes), compute_dtype=torch.float32)
           for axes in ([("sp", 4)], [("dp", 2), ("sp", 2)])}
    for axes, fn in fns.items():
        out[f"encode {axes}"] = fn(frozen, audio)
    try:
        fns[str([("sp", 4)])](frozen, audio[:, :3 * CFG.mel.max_samples])
    except ValueError as e:
        out["encode refusal"] = str(e)
    return out


# ---------------------------------------------------------------------------
# rank side of test_torch_sp_generate.py / test_torch_tp_generate.py
# ---------------------------------------------------------------------------

def generate_cases(rank, world, trees_np, cases):
    """Each case {name, kind ('sp' | 'tp' | 'dp'), axes, tree, ids, mask,
    audio, static} through the port's entry point on the ranks
    of its mesh (the first ranks of the world) -> {name: (tokens,
    num_generated)}."""
    trees = {k: (bridge.from_jax(f, "cpu"), bridge.from_jax(t, "cpu"))
             for k, (f, t) in trees_np.items()}
    out = {}
    for c in cases:
        n = int(np.prod([s for _, s in c["axes"]]))
        mesh = t_mesh.build_mesh(c["axes"], list(range(n)))
        if mesh.rank is None:
            continue
        static = dict(c["static"], device="cpu", compute_dtype=torch.float32)
        if c["kind"] == "sp":
            fn = make_sp_generate(CFG, mesh, **static)
        elif c["kind"] == "tp":
            fn = t_gen.make_tp_generate(CFG, mesh, **static)
        else:
            fn = t_gen.make_dp_generate(CFG, mesh, **static)
        frozen, trainable = trees[c["tree"]]
        audio = None if c["audio"] is None else torch.from_numpy(c["audio"])
        res = fn(frozen, trainable, torch.from_numpy(c["ids"]), torch.from_numpy(c["mask"]),
                 audio)
        out[c["name"]] = (res.tokens, res.num_generated)
    return out


def sampled_dp(rank, world, trees_np, inputs, static):
    """dp 2, sampled, seeds 0 and 1 -> this rank's tokens of each (every
    rank must return the same)."""
    frozen, trainable = (bridge.from_jax(t, "cpu") for t in trees_np)
    mesh = t_mesh.build_mesh([("dp", 2)])
    fn = t_gen.make_dp_generate(CFG, mesh, device="cpu", compute_dtype=torch.float32, **static)
    ids, mask, audio = (torch.from_numpy(a) for a in inputs)
    return [fn(frozen, trainable, ids, mask, audio, seed=s).tokens for s in (0, 1)]
