"""audio_llama_tpu_torch: the PyTorch/CUDA port of audio_llama_tpu.

Frozen Whisper encoder + projector + frozen Llama with LoRA, audio to text,
on one NVIDIA H100. The JAX package `audio_llama_tpu` stays the numerical
reference; this package imports `torch`, never `jax`, and nothing of the JAX
package. Each Pallas kernel on the ported path has a hand-written CUDA kernel
under `csrc/` with a plain PyTorch version beside it (`ops/`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit CPU request they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
