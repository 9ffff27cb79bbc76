"""Run chip_smoke.py's training path (train A and train B at full width, and
with --profile train A's one-step device profile) on the kernels of a given
checkout, so that two checkouts' steps can be compared in one call.

`chip_smoke.train_path`, from the checkout that holds this script: the
port's trainer in-process (`--synthetic_flagship --tokenizer byte`, LoRA
r64) on 24 seeded 30 s WAV clips, run A (B 2, 2 micro-batches a step, 3
steps) and run B (B 8, `--remat`, chunked loss, 2 steps), with its checks of
the losses, launches and checkpoint reloads; each run's `ms_per_step`,
`tokens_per_s`, `mfu` and `peak_mem_gb`, and with --profile
`device_profile` of one train A step (device time by kernel group, busy
share). The package is the one of the checkout named by --checkout
(default: this one), imported and built in place of this one's. Prints the
card's name and power limit, then one JSON line {"A": {...}, "B": {...},
"profile": {...}}; the trainer's own log goes to --log:

    python scripts/train_timing.py --checkout <dir> --profile --log run.log
"""
import argparse
import contextlib
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEEP = ("label", "ms_per_step", "step_ms_each", "tokens_per_s", "mfu", "peak_mem_gb",
        "train_loss", "launches")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT),
                    help="the checkout whose package and kernels run")
    ap.add_argument("--profile", action="store_true", help="add train A's step profile")
    ap.add_argument("--log", default=None, help="file for the trainer's log (default: stderr)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda

    print(cs.gpu_line(), flush=True)
    print(f"kernels: {_cuda.build()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main sets them
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    log_file = open(args.log, "w") if args.log else sys.stderr

    def keep(msg: str) -> None:  # chip_smoke.log, with its JSON lines kept
        print(msg, file=log_file, flush=True)
        if msg.startswith("{"):
            with contextlib.suppress(ValueError):
                lines.append(json.loads(msg))

    cs.log = keep
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(log_file):
        cs.train_path(torch.device("cuda", 0), tmp, profile=args.profile)
    out = {}
    for entry in lines:
        if "train_path" in entry:
            stats = entry["train_path"]
            out[stats["label"][-1]] = {k: stats[k] for k in KEEP if k in stats}
        elif "profile" in entry:
            out["profile"] = entry["profile"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
