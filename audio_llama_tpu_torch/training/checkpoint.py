"""Checkpoints: the trainable tree, the optimizer state, step, epoch, config.

Counterpart of `audio_llama_tpu/training/checkpoint.py`, in its format so a
checkpoint crosses between the packages: one directory per checkpoint
(`checkpoint-{step}`, `final_checkpoint`, `best_model`) holding
`checkpoint.msgpack` (flax's single-file msgpack of `{'model': {'trainable':
...}, 'optimizer': <optax layout>, 'step', 'epoch'}`, written and read by
`training/msgpack_io.py`) and `config.json` (model config, run args, dataset
config, step, epoch). Frozen weights are never saved. `load_checkpoint` also
takes a bare trainable dump and the reference trainer's PyTorch `.pt`
(`load_reference_checkpoint`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..bridge import ParamTree, to_numpy
from ..config import AudioLLMConfig
from . import msgpack_io

logger = logging.getLogger("audio_llama_tpu_torch")

CKPT_FILE = "checkpoint.msgpack"
CONFIG_FILE = "config.json"
TORCH_CKPT_FILE = "checkpoint.pt"


def save_checkpoint(
    out_dir: str,
    *,
    trainable: ParamTree,
    opt_state: Any,
    step: int,
    epoch: int,
    model_cfg: AudioLLMConfig,
    args: Optional[dict] = None,
    dataset_config: Optional[dict] = None,
    final: bool = False,
    best: bool = False,
) -> str:
    """Write a checkpoint directory; returns its path. `opt_state` is the
    optimizer state in optax's layout (`OptaxAdamW.optax_state`)."""
    name = "best_model" if best else "final_checkpoint" if final else f"checkpoint-{step}"
    path = os.path.join(out_dir, name)
    os.makedirs(path, exist_ok=True)
    state = {
        "model": {"trainable": to_numpy(trainable)},
        "optimizer": opt_state,
        "step": int(step),
        "epoch": int(epoch),
    }
    with open(os.path.join(path, CKPT_FILE), "wb") as f:
        f.write(msgpack_io.serialize(state))
    meta = {
        "model_config": model_cfg.to_dict(),
        "args": args or {},
        "dataset_config": dataset_config or {},
        "step": int(step),
        "epoch": int(epoch),
    }
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def _resolve_ckpt_file(path: str) -> str:
    if os.path.isdir(path):
        ours = os.path.join(path, CKPT_FILE)
        theirs = os.path.join(path, TORCH_CKPT_FILE)
        if not os.path.exists(ours) and os.path.exists(theirs):
            return theirs  # a reference trainer's directory holds checkpoint.pt only
        return ours
    return path


def _is_torch_checkpoint(file_path: str) -> bool:
    if file_path.endswith(".pt") or file_path.endswith(".pth"):
        return True
    try:
        with open(file_path, "rb") as f:
            magic = f.read(4)
    except OSError:
        return False
    # torch.save's zip ("PK") or a pickle (0x80); a msgpack map starts with neither
    return magic[:2] == b"PK" or (len(magic) >= 2 and magic[0] == 0x80)


def load_metadata(path: str) -> dict:
    d = path if os.path.isdir(path) else os.path.dirname(path)
    cfg_path = os.path.join(d, CONFIG_FILE)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return json.load(f)
    return {}


def _fill(template: ParamTree, raw: dict) -> ParamTree:
    """A new ParamTree shaped and typed like `template` (same device, same
    requires_grad), holding the numpy leaves of `raw`."""
    out = {}
    for name, node in template.items():
        if name not in raw:
            raise ValueError(f"checkpoint is missing {name!r}")
        if isinstance(node, ParamTree):
            out[name] = _fill(node, raw[name])
            continue
        arr = np.asarray(raw[name])
        if arr.shape != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {name!r} has shape {arr.shape}, "
                             f"want {tuple(node.shape)}")
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        out[name] = t.to(device=node.device, dtype=node.dtype)
    extra = set(raw) - set(template.keys())
    if extra:
        raise ValueError(f"checkpoint has leaves the model lacks: {sorted(extra)}")
    return ParamTree(out, requires_grad=any(p.requires_grad for p in template.parameters()))


def load_checkpoint(path: str, *,
                    trainable_template: ParamTree) -> Tuple[ParamTree, Optional[dict], int, int]:
    """(trainable, optimizer state in optax's layout or None, step, epoch)
    from a checkpoint directory or file. The template gives the tree's
    structure, dtypes and device. Reads our layout, a bare trainable dump
    (step and epoch 0) and the reference trainer's `.pt`."""
    file_path = _resolve_ckpt_file(path)
    if _is_torch_checkpoint(file_path):
        trainable, step, epoch = load_reference_checkpoint(
            file_path, trainable_template=trainable_template)
        return trainable, None, step, epoch
    with open(file_path, "rb") as f:
        raw = msgpack_io.restore(f.read())
    if isinstance(raw, dict) and "model" in raw:
        trainable = _fill(trainable_template, raw["model"]["trainable"])
        return trainable, raw.get("optimizer"), int(raw["step"]), int(raw["epoch"])
    return _fill(trainable_template, raw), None, 0, 0


def _lora_target_and_layer(module_name: str):
    """'model.layers.17.self_attn.q_proj' -> ('q_proj', 17)."""
    parts = module_name.split(".")
    for i, p in enumerate(parts):
        if p == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            return parts[-1], int(parts[i + 1])
    return parts[-1], None


def load_reference_checkpoint(path: str, *,
                              trainable_template: ParamTree) -> Tuple[ParamTree, int, int]:
    """Import the reference trainer's PyTorch checkpoint (`{model:
    {projector: state_dict, lora_layers: {module_name: state_dict}}, step,
    epoch, ...}` or the bare `{projector, lora_layers}`) -> (trainable,
    step, epoch). Projector `layers.{0,2}.{weight,bias}` become fc1 / fc2
    (Linear weights transposed to [in, out]) and `layers.3` the LayerNorm;
    lora_A [r, in] and lora_B [out, r] land transposed in layer `i` of the
    stacked a [L, in, r] and b [L, r, out]. Targets or layers missing from
    the file keep the template's values."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    step = int(raw.get("step", 0)) if isinstance(raw, dict) else 0
    epoch = int(raw.get("epoch", 0)) if isinstance(raw, dict) else 0
    model = raw.get("model", raw)
    if not isinstance(model, dict) or "projector" not in model:
        raise ValueError(f"{path}: not a recognized reference checkpoint (expected "
                         "'model.projector' or top-level 'projector')")
    out = to_numpy(trainable_template)

    def npy(t):
        return t.detach().cpu().float().numpy()

    proj_sd, proj = model["projector"], out["projector"]
    for src, branch, key, transpose in (
            ("layers.0.weight", proj["fc1"], "w", True), ("layers.0.bias", proj["fc1"], "b", False),
            ("layers.2.weight", proj["fc2"], "w", True), ("layers.2.bias", proj["fc2"], "b", False),
            ("layers.3.weight", proj["ln"], "scale", False),
            ("layers.3.bias", proj["ln"], "bias", False)):
        if src not in proj_sd:
            raise ValueError(f"{path}: projector state dict missing {src!r}")
        w = npy(proj_sd[src])
        w = w.T if transpose else w
        if w.shape != branch[key].shape:
            raise ValueError(f"{path}: projector {src} shape {w.shape} != ours "
                             f"{branch[key].shape}")
        branch[key] = w.astype(branch[key].dtype)

    lora_sd = model.get("lora_layers") or {}
    if lora_sd and "lora" not in out:
        raise ValueError(f"{path} carries LoRA weights but this model was built without LoRA "
                         "(cfg.lora is None)")
    for module_name, sd in lora_sd.items():
        target, layer = _lora_target_and_layer(module_name)
        if layer is None:
            raise ValueError(f"{path}: cannot parse decoder layer index from LoRA module name "
                             f"{module_name!r}")
        if target not in out["lora"]["layers"]:
            logger.warning("reference checkpoint LoRA target %r not in our target set; "
                           "skipping %s", target, module_name)
            continue
        br = out["lora"]["layers"][target]
        a_t, b_t = npy(sd["lora_A"]).T, npy(sd["lora_B"]).T  # [in, r], [r, out]
        L = br["a"].shape[0]
        if not 0 <= layer < L:
            raise ValueError(f"{path}: LoRA layer index {layer} out of range (L={L})")
        if a_t.shape != br["a"].shape[1:] or b_t.shape != br["b"].shape[1:]:
            raise ValueError(f"{path}: LoRA {module_name} shapes {a_t.shape}/{b_t.shape} != ours "
                             f"{br['a'].shape[1:]}/{br['b'].shape[1:]} (rank or model dims)")
        br["a"][layer] = a_t.astype(br["a"].dtype)
        br["b"][layer] = b_t.astype(br["b"].dtype)
    return _fill(trainable_template, out), step, epoch
