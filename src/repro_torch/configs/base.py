"""Model/config registry for the FMplex reproduction.

Every architecture (the 10 assigned LM-family archs + the paper's own
representation backbone) is described by a single ``ModelConfig``. The model zoo
(``repro.models``) is config-driven: block kinds, attention flavor, MoE, and
frontend stubs are all selected from fields here, so one implementation serves
every arch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Block kinds understood by repro.models.blocks
ATTN = "attn"          # (SWA-)GQA attention + MLP/MoE
MAMBA = "mamba"        # Mamba SSM block (Jamba)
SLSTM = "slstm"        # xLSTM sLSTM block
MLSTM = "mlstm"        # xLSTM mLSTM block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm | representation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # attention flavor
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA width (h2o-danube, jamba attn layers)
    rope_theta: float = 10000.0
    mrope_sections: Optional[Sequence[int]] = None  # Qwen2-VL M-RoPE (t, h, w)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # apply MoE FFN every k-th layer (jamba: 2)

    # block pattern: None -> all ATTN. Otherwise a cycle applied over layers,
    # e.g. jamba 1:7 attn:mamba -> ("mamba",)*3 + ("attn",) + ("mamba",)*4 cycled.
    block_pattern: Optional[Sequence[str]] = None

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0

    # representation-based FM (paper's MOMENT analogue): encoder-only, no LM head
    is_representation: bool = False

    # modality frontend stub: if set, input_specs() provides precomputed
    # frame/patch embeddings of shape (batch, seq, d_model) instead of token ids.
    # "ts_patches" (moment-large) is such a stub too: the caller passes
    # patch embeddings made elsewhere (numpy), no patching frontend runs.
    frontend_stub: Optional[str] = None   # None | "audio_frames" | "vision_patches" | "ts_patches"

    # mamba-specific
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # xLSTM-specific
    xlstm_proj_factor: float = 2.0

    # MoE dispatch strategy: "gshard" (capacity einsum, baseline) or
    # "scatter" (gather/scatter, beyond-paper optimization — see §Perf)
    moe_dispatch: str = "gshard"

    # numerics / misc
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    true_vocab: Optional[int] = None  # set when vocab was padded for TP
    source: str = ""                 # provenance note

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # ---- derived ----
    @property
    def blocks(self) -> Sequence[str]:
        """Per-layer block kind, length num_layers."""
        if self.block_pattern is None:
            return tuple(ATTN for _ in range(self.num_layers))
        pat = tuple(self.block_pattern)
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports long-context decode (SSM/hybrid/SWA)."""
        if any(b in (MAMBA, SLSTM, MLSTM) for b in self.blocks):
            return True
        return self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        """Encoder-only (representation) archs have no decode step."""
        return not self.is_representation

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings and not self.is_representation:
            n += self.vocab_size * d                  # lm head
        for i, kind in enumerate(self.blocks):
            if kind == ATTN:
                n += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d  # qkvo
                if self.qkv_bias:
                    n += (h + 2 * kv) * hd
                n += self._ffn_params(i)
                n += 2 * d                             # norms
            elif kind == MAMBA:
                d_in = self.mamba_expand * d
                n += d * (2 * d_in)                    # in_proj
                n += d_in * self.mamba_d_conv          # conv
                n += d_in * (self.mamba_d_state * 2 + 1)  # x_proj (B,C,dt low-rank-ish)
                n += d_in * self.mamba_d_state         # A
                n += d_in * 2                          # D, dt_bias
                n += d_in * d                          # out_proj
                n += d                                 # norm
                if self.uses_moe and self._layer_has_moe(i):
                    n += self._ffn_params(i)
                    n += d
            elif kind in (SLSTM, MLSTM):
                pf = self.xlstm_proj_factor
                d_in = int(pf * d)
                n += d * (4 * d_in) + d_in * d         # gates up + down (approx)
                n += 2 * d
        if self.is_encoder_decoder:
            # encoder blocks (attn + mlp) + cross-attention in decoder counted above;
            # add encoder stack + decoder cross-attn
            enc = self.encoder_layers * (4 * d * d + self._ffn_params(0) + 2 * d)
            cross = self.num_layers * (d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d + d)
            n += enc + cross
        return n

    def _layer_has_moe(self, i: int) -> bool:
        return self.uses_moe and (i % self.moe_every == self.moe_every - 1)

    def _ffn_params(self, i: int) -> int:
        d = self.d_model
        if self.d_ff == 0:
            return 0
        if self._layer_has_moe(i):
            return self.num_experts * 3 * d * self.d_ff
        if self.uses_moe and self.moe_every > 1:
            return 3 * d * self.d_ff  # dense interleave layer
        if self.uses_moe:
            return self.num_experts * 3 * d * self.d_ff
        return 3 * d * self.d_ff      # gated (SwiGLU) FFN

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.uses_moe:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        moe_layers = sum(1 for i in range(self.num_layers) if self._layer_has_moe(i))
        unused = moe_layers * (self.num_experts - self.experts_per_token) * 3 * d * self.d_ff
        return full - unused


_REGISTRY: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import side-effect registration
    from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    import math
    period = len(cfg.block_pattern) if cfg.block_pattern else 1
    if cfg.num_experts > 0:
        period = math.lcm(period, cfg.moe_every)
    small = dict(
        num_layers=period if period > 1 else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        head_dim=16,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        sliding_window=64 if cfg.sliding_window else None,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else None,
        name=cfg.name + "-smoke",
    )
    small.update(over)
    return dataclasses.replace(cfg, **small)
