"""Model/run configuration dataclasses for the PyTorch port.

A field-for-field twin of `audio_llama_tpu/config.py`: the same dataclasses,
defaults and JSON, so a config written by either package loads in the other.
The port keeps its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


class _ConfigBase:
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict):
        import typing

        hints = typing.get_type_hints(cls)
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in names:
                continue
            t = hints.get(k)
            # Unwrap Optional[...]
            if typing.get_origin(t) is typing.Union:
                args = [a for a in typing.get_args(t) if a is not type(None)]
                if len(args) == 1:
                    t = args[0]
            # Re-hydrate nested configs.
            if isinstance(v, dict) and isinstance(t, type) and dataclasses.is_dataclass(t):
                v = t.from_dict(v)
            elif isinstance(v, list) and typing.get_origin(t) is tuple:
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RopeScalingConfig(_ConfigBase):
    """Llama-3 style rope scaling (HF `rope_scaling` with rope_type='llama3')."""

    rope_type: str = "llama3"
    factor: float = 32.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass(frozen=True)
class LlamaConfig(_ConfigBase):
    """Llama decoder config (mirrors the fields of HF LlamaConfig we consume)."""

    vocab_size: int = 128256
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 28
    num_heads: int = 24
    num_kv_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScalingConfig] = field(
        default_factory=RopeScalingConfig
    )
    tie_word_embeddings: bool = True
    # Attention bias (Llama has none; kept for generality).
    attention_bias: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @classmethod
    def llama32_3b(cls) -> "LlamaConfig":
        """meta-llama/Llama-3.2-3B-Instruct (reference default llama_path,
        reference src/train.py:33-34)."""
        return cls()

    @classmethod
    def llama32_1b(cls) -> "LlamaConfig":
        return cls(
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=32,
            num_kv_heads=8,
            head_dim=64,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LlamaConfig":
        """Tiny config for tests: 2 layers, GQA, rope-scaled — all the shape
        machinery of the real thing at toy dims."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_position_embeddings=4096,
            rope_theta=10000.0,
            rope_scaling=None,
            tie_word_embeddings=False,
        )

    @classmethod
    def from_hf_config(cls, hf: dict) -> "LlamaConfig":
        """Build from an HF config.json dict (as found in a local checkpoint dir)."""
        rs = hf.get("rope_scaling")
        rope_scaling = None
        if rs:
            rope_scaling = RopeScalingConfig(
                rope_type=rs.get("rope_type", rs.get("type", "llama3")),
                factor=rs.get("factor", 32.0),
                low_freq_factor=rs.get("low_freq_factor", 1.0),
                high_freq_factor=rs.get("high_freq_factor", 4.0),
                original_max_position_embeddings=rs.get(
                    "original_max_position_embeddings", 8192
                ),
            )
        num_heads = hf["num_attention_heads"]
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=hf.get("num_key_value_heads", num_heads),
            head_dim=hf.get("head_dim", hf["hidden_size"] // num_heads),
            max_position_embeddings=hf.get("max_position_embeddings", 131072),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 500000.0),
            rope_scaling=rope_scaling,
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False),
        )


@dataclass(frozen=True)
class WhisperConfig(_ConfigBase):
    """Whisper *encoder* config (the reference only uses the encoder,
    reference src/models/base.py:22-24)."""

    d_model: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    ffn_dim: int = 5120
    num_mel_bins: int = 128
    max_source_positions: int = 1500  # 30 s * 100 fps / 2 (conv stride)
    layer_norm_eps: float = 1e-5
    # HF Whisper uses exact (erf) GELU; tanh approximation is faster on the
    # VPU with ~1e-3 activation deltas — opt-in for throughput.
    gelu_approx: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def large_v3_turbo(cls) -> "WhisperConfig":
        """openai/whisper-large-v3-turbo (reference default whisper_path,
        reference src/train.py:35-36): 32-layer, d_model 1280, 128 mels."""
        return cls()

    @classmethod
    def tiny_hf(cls) -> "WhisperConfig":
        """openai/whisper-tiny dims (4 layers, d_model 384, 80 mels)."""
        return cls(
            d_model=384, num_layers=4, num_heads=6, ffn_dim=1536, num_mel_bins=80
        )

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        """Toy config for tests."""
        return cls(
            d_model=64,
            num_layers=2,
            num_heads=4,
            ffn_dim=128,
            num_mel_bins=80,
            max_source_positions=64,
        )

    @classmethod
    def from_hf_config(cls, hf: dict) -> "WhisperConfig":
        return cls(
            d_model=hf["d_model"],
            num_layers=hf["encoder_layers"],
            num_heads=hf["encoder_attention_heads"],
            ffn_dim=hf["encoder_ffn_dim"],
            num_mel_bins=hf["num_mel_bins"],
            max_source_positions=hf.get("max_source_positions", 1500),
        )


@dataclass(frozen=True)
class MelConfig(_ConfigBase):
    """Log-mel frontend. Defaults follow Whisper's featurizer (n_fft=400,
    hop=160 — also the reference's hand-rolled mel, reference src/dataset.py:125-131).

    The reference has TWO inconsistent featurizers (torchaudio power-mel + log(x+1e-9)
    in training vs WhisperFeatureExtractor in inference — SURVEY.md §2). We ship one
    canonical Whisper-compatible frontend (`style='whisper'`) plus a `style='ref'`
    compatibility mode reproducing the reference's training-side numerics.
    """

    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    num_mel_bins: int = 128
    max_audio_seconds: float = 30.0
    style: str = "whisper"  # 'whisper' | 'ref'

    @property
    def max_samples(self) -> int:
        return int(self.max_audio_seconds * self.sample_rate)

    @property
    def num_frames(self) -> int:
        # Whisper: 30 s * 16 kHz / 160 hop = 3000 frames.
        return self.max_samples // self.hop_length


@dataclass(frozen=True)
class ProjectorConfig(_ConfigBase):
    """Audio projector MLP: Linear -> GELU -> Linear -> LayerNorm
    (reference src/models/projector.py:5-19). hidden defaults to (in+out)//2."""

    input_dim: int = 1280
    output_dim: int = 3072
    hidden_dim: Optional[int] = None

    @property
    def hidden(self) -> int:
        return (
            self.hidden_dim
            if self.hidden_dim is not None
            else (self.input_dim + self.output_dim) // 2
        )


@dataclass(frozen=True)
class LoraConfig(_ConfigBase):
    """LoRA adapters on the Llama linears.

    The reference targets {q,k,v,gate,up,down}_proj — deliberately NOT o_proj
    (reference src/models/lora.py:29) — with rank 64 effective (reference
    src/models/allm.py:9; train.py's --lora_rank flag is never plumbed through,
    SURVEY.md §2). scaling = alpha/rank; A init zeros, B init N(0, 0.01)
    (reference src/models/lora.py:9-18).
    """

    rank: int = 64
    alpha: float = 16.0
    target_modules: Tuple[str, ...] = (
        "q_proj",
        "k_proj",
        "v_proj",
        "gate_proj",
        "up_proj",
        "down_proj",
    )
    # 'ref' = A zeros / B normal(0.01) like the reference; 'standard' = A
    # normal / B zeros (classic LoRA init; both give zero initial delta).
    init: str = "ref"

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class AudioLLMConfig(_ConfigBase):
    """Composite model config (reference AudioLLM, src/models/allm.py:8-45)."""

    llama: LlamaConfig = field(default_factory=LlamaConfig.llama32_3b)
    whisper: WhisperConfig = field(default_factory=WhisperConfig.large_v3_turbo)
    mel: MelConfig = field(default_factory=MelConfig)
    lora: Optional[LoraConfig] = field(default_factory=LoraConfig)
    projector_hidden_dim: Optional[int] = None
    # Delimiter special tokens (reference src/models/allm.py:34-35).
    audio_start_token: str = "<audio>"
    audio_end_token: str = "</audio>"
    # 'prepend': audio block placed before all text (what the reference's code
    # does, src/models/allm.py:156-170). 'inplace': splice at the <audio>
    # placeholder position (what its docstring intends). We implement both.
    splice_mode: str = "prepend"

    @property
    def projector(self) -> ProjectorConfig:
        return ProjectorConfig(
            input_dim=self.whisper.d_model,
            output_dim=self.llama.hidden_size,
            hidden_dim=self.projector_hidden_dim,
        )

    @property
    def audio_seq_len(self) -> int:
        """Encoder frames per 30 s clip (1500 for whisper; reference splice adds
        this + 2 delimiters, SURVEY.md §2)."""
        return self.whisper.max_source_positions

    @classmethod
    def tiny(cls) -> "AudioLLMConfig":
        return cls(
            llama=LlamaConfig.tiny(),
            whisper=WhisperConfig.tiny(),
            mel=MelConfig(num_mel_bins=80, max_audio_seconds=1.28),
            lora=LoraConfig(rank=4, alpha=8),
        )

    def from_parts(self, **kw) -> "AudioLLMConfig":
        return self.replace(**kw)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
