"""Run the int4 decode paths of chip_smoke.py on one checkout's kernels, and
compare two runs' greedy token chains and decode profiles.

    python scripts/int4_decode_paths.py --checkout <dir> --log <file>
    python scripts/int4_decode_paths.py --compare <parent.log> <change.log>

A run: chip_smoke's int4 path (int4w+kv4, B = 4, 32 greedy tokens, with its
torch.profiler breakdown of one decode token by kernel group), smooth_path
(RTN, clipped, smoothed and GPTQ trees at group 32; B = 4 and 1, and B = 4
under INT4_BK=768) and serve_path (the serving pool behind its HTTP
server), each writing its JSON lines to stdout and to --log, then the
card's name and power limit. Each smooth_path run also logs
`top2_margin_per_step`: at every greedy step of its timed run, each row's
gap between its two largest logits (f32), which says whether a token
another build picks differently was a near-tie (the capture adds a top-2
per step, so these runs' decode times are not chip_smoke's). The phases
are chip_smoke.py's from the checkout that holds this script; the
package, kernels included, is --checkout's (default: this one).

--compare reads two such logs (no card needed) and prints one JSON object:
for every greedy chain (the int4 path, each smooth_path run, each pool
request) whether the two are equal or the step where they part, with the
parted row's top-2 margin at that step in both runs where the logs hold
it and, for scale, the median margin of the first run's chain, and each
run's decode ms per token and per-token device time by kernel group.
"""
import argparse
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(checkout: str, log_path: str) -> int:
    sys.path.insert(0, str(Path(checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda

    out = open(log_path, "w")

    def log(msg: str) -> None:
        print(msg, flush=True)
        out.write(msg + "\n")
        out.flush()

    cs.log = log  # the phases log through chip_smoke's module global
    capture_margins(cs)
    log(f"kernels: {_cuda.build()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.int4_path(dev, profile=True)
    torch.cuda.empty_cache()
    cs.smooth_path(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cs.serve_path(dev, tmp)
    log(cs.gpu_line())
    out.close()
    return 0


def capture_margins(cs) -> None:
    """Record each greedy step's top-2 logit gap per row, and hand the last
    N_NEW steps (the timed run's) of every `timed_generate` call to its
    result as `top2_margin_per_step` [step][row]."""
    from audio_llama_tpu_torch.ops import sampling

    steps = []
    sample = sampling.sample_token

    def recording(logits, *a, **kw):
        top = logits.float().topk(2, dim=-1).values
        steps.append(top[:, 0] - top[:, 1])
        return sample(logits, *a, **kw)

    timed = cs.timed_generate

    def timed_with_margins(*a, **kw):
        steps.clear()
        out, launches = timed(*a, **kw)
        out["top2_margin_per_step"] = [t.tolist() for t in steps[-cs.N_NEW:]]
        return out, launches

    sampling.sample_token = recording
    cs.timed_generate = timed_with_margins


def chains(path: str) -> dict:
    """-> {"chains": {name: tokens}, "margins": {name: [step][row]},
    "decode": {...}} of one log."""
    found, margins, decode = {}, {}, {}
    for line in Path(path).read_text().splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if "int4_path" in d:
            found["int4 B=4"] = d["int4_path"]["greedy_tokens"]
            decode["int4 B=4 decode_ms_per_token"] = d["int4_path"]["decode_ms_per_token"]
        elif "profile" in d and d["profile"]["path"] == "int4w+kv4, B=4":
            p = d["profile"]
            decode["int4 B=4 device ms per token"] = p["decode_per_token_device_ms"]
            decode["int4 B=4 device ms per token by group"] = p["decode_per_token_by_group_ms"]
            decode["int4 B=4 wall ms per token (profiled)"] = p["decode_per_token_wall_ms"]
        elif "smooth_path" in d:
            for name, r in d["smooth_path"]["runs"].items():
                found[f"smooth_path {name}"] = r["greedy_tokens"]
                if "top2_margin_per_step" in r:
                    margins[f"smooth_path {name}"] = r["top2_margin_per_step"]
                decode[f"smooth_path {name} decode_ms_per_token"] = r["decode_ms_per_token"]
        elif "serve_path" in d:
            for r in d["serve_path"]["per_request"]:
                if "greedy_tokens" in r:
                    found[f"pool request {r['request']}"] = [r["greedy_tokens"]]
            decode["pool tokens_per_s"] = d["serve_path"]["tokens_per_s"]
    return {"chains": found, "margins": margins, "decode": decode}


def parting(a, b):
    """None where the chains are equal, else [row, step] of the first
    difference (the length where one ends first)."""
    for r, (ra, rb) in enumerate(zip(a, b)):
        for s, (x, y) in enumerate(zip(ra, rb)):
            if x != y:
                return [r, s]
        if len(ra) != len(rb):
            return [r, min(len(ra), len(rb))]
    return None if len(a) == len(b) else [min(len(a), len(b)), 0]


def parted(name: str, at, a: dict, b: dict) -> dict:
    """The parting step of chain `name` with the row's top-2 margins there."""
    out = {"parts at [row, step]": at}
    row, step = at
    for key, run in (("first", a), ("second", b)):
        m = run["margins"].get(name)
        if m is not None and step < len(m):
            out[f"top2_margin {key}"] = m[step][row]
    m = a["margins"].get(name)
    if m:
        flat = sorted(v for s in m for v in s)
        out["median top2_margin first"] = flat[len(flat) // 2]
    return out


def compare(first: str, second: str) -> int:
    a, b = chains(first), chains(second)
    names = sorted(set(a["chains"]) | set(b["chains"]))
    result = {}
    for n in names:
        if n not in a["chains"] or n not in b["chains"]:
            result[n] = "missing"
            continue
        at = parting(a["chains"][n], b["chains"][n])
        result[n] = "equal" if at is None else parted(n, at, a, b)
    print(json.dumps({"chains": result, "first": a["decode"], "second": b["decode"]}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose package runs")
    ap.add_argument("--log", help="the run's log file")
    ap.add_argument("--compare", nargs=2, metavar=("FIRST", "SECOND"),
                    help="compare two runs' logs")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not args.log:
        ap.error("--log is required for a run")
    return run(args.checkout, args.log)


if __name__ == "__main__":
    sys.exit(main())
