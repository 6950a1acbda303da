"""Configuration dataclasses of the PyTorch port.

A copy of flash_vstream_tpu/core/config.py with the same classes, field
names and defaults (tests/test_torch_no_jax.py holds the two equal field for
field), so the port imports nothing of the JAX package.

Defaults mirror the reference hyperparameters:
- STAR memory: cur 1x8^2, long 25x4^2, Turing 25x1^2, weighted_kmeans
  (Flash-VStream-LLaVA/scripts/train_and_eval.sh:7-14, flash_vstream/train/train.py:66-90)
- Flash memory: temporal 120 kmeans_ordered pool 2, spatial 60 klarge_retrieve
  (Flash-VStream-Qwen/models/flash_memory_constants.py:1-8)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Special token ids (reference: Flash-VStream-LLaVA/flash_vstream/constants.py:9-15)
# ---------------------------------------------------------------------------
IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
DEFAULT_VIDEO_TOKEN = "<video>"

# Qwen2-VL special token ids (HF tokenizer values)
QWEN_VISION_START_TOKEN_ID = 151652
QWEN_VISION_END_TOKEN_ID = 151653
QWEN_IMAGE_TOKEN_ID = 151655
QWEN_VIDEO_TOKEN_ID = 151656


@dataclass(frozen=True)
class STARConfig:
    """LLaVA-generation STAR memory configuration.

    Reference semantics: flash_vstream/model/vstream_arch.py:214-277.
    """
    # number of frames kept at full spatial resolution ("current" memory)
    current_length: int = 1
    # spatial grid side of current memory tokens (8 -> 8x8 = 64 tokens/frame)
    current_size: int = 8
    # long memory: clustered temporal memory
    long_length: int = 25
    long_size: int = 4
    # Turing (abstract/NTM) memory
    turing_length: int = 25
    turing_size: int = 1
    turing_update_ratio: float = 0.2
    turing_hidden_dim: int = 32
    # number of retrieved key frames appended to current memory
    key_length: int = 3
    # temporal compression op for long memory
    compress_type: str = "weighted_kmeans"
    # maximum frames consumed per video (train/eval pipelines)
    video_max_frames: int = 50
    # static padded frame capacity used by jitted consolidation (streaming bank)
    max_frames_static: int = 64

    @property
    def tokens_per_video(self) -> int:
        return (
            self.turing_length * self.turing_size**2
            + self.long_length * self.long_size**2
            + (self.key_length + self.current_length) * self.current_size**2
        )


@dataclass(frozen=True)
class FlashMemoryConfig:
    """Qwen-generation Flash memory configuration.

    Reference: Flash-VStream-Qwen/models/flash_memory_constants.py:1-8 and
    models/vstream_qwen2vl_model.py:79-106. Lengths are in *raw* (pre temporal
    patch-merge) frames; effective grid lengths are halved, matching
    get_real_grid_thw (vstream_qwen2vl_model.py:43-76).
    """
    temporal_length: int = 120      # raw frames; grid length = 60
    temporal_method: str = "kmeans_ordered"
    temporal_poolsize: int = 2
    temporal_pca_dim: int = 32
    spatial_length: int = 60        # raw frames; grid length = 30
    spatial_method: str = "klarge_retrieve"

    def __post_init__(self):
        assert self.temporal_length % 2 == 0
        assert self.spatial_length % 2 == 0

    @property
    def csm_grid_len(self) -> int:
        return self.temporal_length // 2

    @property
    def dam_grid_len(self) -> int:
        return self.spatial_length // 2

    def to_dict(self) -> dict:
        return {
            "flash_memory_temporal_length": self.temporal_length,
            "flash_memory_temporal_method": self.temporal_method,
            "flash_memory_temporal_poolsize": self.temporal_poolsize,
            "flash_memory_temporal_pca_dim": self.temporal_pca_dim,
            "flash_memory_spatial_length": self.spatial_length,
            "flash_memory_spatial_method": self.spatial_method,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FlashMemoryConfig":
        return cls(
            temporal_length=d["flash_memory_temporal_length"],
            temporal_method=d["flash_memory_temporal_method"],
            temporal_poolsize=d["flash_memory_temporal_poolsize"],
            temporal_pca_dim=d.get("flash_memory_temporal_pca_dim", 32),
            spatial_length=d["flash_memory_spatial_length"],
            spatial_method=d["flash_memory_spatial_method"],
        )


# ---------------------------------------------------------------------------
# Model architecture configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VitConfig:
    """Generic ViT encoder config, covers CLIP ViT-L/14 and Qwen2-VL ViT."""
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    # Qwen2-VL specific
    temporal_patch_size: int = 1       # 2 for qwen2-vl
    spatial_merge_size: int = 1        # 2 for qwen2-vl
    in_channels: int = 3
    # layer norm eps
    layer_norm_eps: float = 1e-5
    # activation: "quick_gelu" for CLIP, "gelu" elsewhere
    hidden_act: str = "quick_gelu"
    # which hidden layer's output to return (-2 = penultimate, CLIP LLaVA default)
    select_layer: int = -2
    # rotary embedding for qwen2-vl vision
    use_rope_2d: bool = False
    # output dim after patch merger (qwen2-vl): LLM hidden size
    merger_out_dim: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size


CLIP_VIT_L14 = VitConfig()

QWEN2_VL_VIT = VitConfig(
    hidden_size=1280,
    intermediate_size=1280 * 4,  # mlp_ratio=4
    num_layers=32,
    num_heads=16,
    patch_size=14,
    image_size=0,  # variable resolution
    temporal_patch_size=2,
    spatial_merge_size=2,
    hidden_act="quick_gelu",
    use_rope_2d=True,
    merger_out_dim=3584,
)


@dataclass(frozen=True)
class LLMConfig:
    """Decoder-only transformer config covering Llama/Vicuna and Qwen2."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # qkv bias (True for Qwen2)
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    # M-RoPE section sizes over head_dim//2 (Qwen2-VL: (16, 24, 24))
    mrope_sections: Optional[Tuple[int, int, int]] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


VICUNA_7B = LLMConfig()

QWEN2_VL_7B = LLMConfig(
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    max_position_embeddings=32768,
    rms_norm_eps=1e-6,
    rope_theta=1000000.0,
    attention_bias=True,
    mrope_sections=(16, 24, 24),
)


@dataclass(frozen=True)
class ProjectorConfig:
    """Vision->LLM projector (reference: multimodal_projector/builder.py:35-51)."""
    projector_type: str = "mlp2x_gelu"
    input_dim: int = 1024
    output_dim: int = 4096
    # mm_use_4_vision_tokens concatenates 2x2 neighbor patches -> 4x input dim
    use_4_vision_tokens: bool = False

    @property
    def effective_input_dim(self) -> int:
        return self.input_dim * (4 if self.use_4_vision_tokens else 1)


@dataclass(frozen=True)
class VStreamLLaVAConfig:
    """Composition config: CLIP ViT + STAR memory + projector + Vicuna."""
    vit: VitConfig = field(default_factory=lambda: CLIP_VIT_L14)
    llm: LLMConfig = field(default_factory=lambda: VICUNA_7B)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    star: STARConfig = field(default_factory=STARConfig)
    max_seq_len: int = 2048

    def replace(self, **kw) -> "VStreamLLaVAConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class VStreamQwenConfig:
    """Composition config: Qwen2-VL ViT + Flash memory + Qwen2 decoder."""
    vit: VitConfig = field(default_factory=lambda: QWEN2_VL_VIT)
    llm: LLMConfig = field(default_factory=lambda: QWEN2_VL_7B)
    flash_memory: FlashMemoryConfig = field(default_factory=FlashMemoryConfig)
    max_seq_len: int = 8192
    image_token_id: int = QWEN_IMAGE_TOKEN_ID
    video_token_id: int = QWEN_VIDEO_TOKEN_ID
    vision_start_token_id: int = QWEN_VISION_START_TOKEN_ID

    def replace(self, **kw) -> "VStreamQwenConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Tiny configs for tests / dry runs
# ---------------------------------------------------------------------------

def tiny_llava_config() -> VStreamLLaVAConfig:
    return VStreamLLaVAConfig(
        vit=VitConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                      num_heads=4, patch_size=14, image_size=112,
                      select_layer=-2),
        llm=LLMConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      max_position_embeddings=512),
        projector=ProjectorConfig(projector_type="mlp2x_gelu", input_dim=32,
                                  output_dim=64),
        star=STARConfig(long_length=4, long_size=2, turing_length=3,
                        turing_size=1, current_size=8, key_length=2,
                        turing_hidden_dim=8, video_max_frames=16,
                        max_frames_static=16),
        max_seq_len=512,
    )


def tiny_qwen_config() -> VStreamQwenConfig:
    return VStreamQwenConfig(
        vit=VitConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                      num_heads=4, patch_size=14, image_size=0,
                      temporal_patch_size=2, spatial_merge_size=2,
                      use_rope_2d=True, merger_out_dim=64),
        llm=LLMConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      max_position_embeddings=1024, attention_bias=True,
                      mrope_sections=(2, 3, 3)),
        flash_memory=FlashMemoryConfig(temporal_length=8, spatial_length=4),
        max_seq_len=1024,
        # ByteTokenizer special ids (see preprocess/qwen_processor.py)
        image_token_id=264,
        video_token_id=263,
        vision_start_token_id=261,
    )
