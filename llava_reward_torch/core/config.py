"""Model / reward configuration dataclasses for the PyTorch port.

The port keeps its own copy of the JAX package's configs
(``llava_reward_tpu/core/config.py``: VisionConfig, RopeScalingConfig,
DecoderConfig, Phi3VConfig, phi35_vision_config, phi3v_tiny_config,
RewardConfig with its checkpoint-contract helpers, QwenVisionConfig,
QwenTextConfig, Qwen25VLConfig, qwen25_vl_7b_config, qwen_tiny_config,
LlavaNextConfig, llava_tiny_config), su-RoPE factor tables verbatim, so that
it imports nothing from that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class VisionConfig:
    """CLIP-style vision tower config.

    Defaults are CLIP ViT-L/14-336 as hard-coded by the reference
    (modeling_phi3_v.py:68-83): 24 layers, hidden 1024, 16 heads,
    quick_gelu, patch 14, image 336 -> 24x24=576 patches + 1 CLS.
    """

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # Feature extraction: the reference takes hidden_states[layer_idx] with
    # layer_idx=-2 (penultimate; modeling_phi3_v.py:208-219), i.e. the output
    # of the first (num_layers + layer_idx + 1) layers, no final layernorm,
    # CLS token dropped.
    feature_layer_idx: int = -2

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_active_layers(self) -> int:
        """Layers actually executed for feature extraction.

        hidden_states[-2] == output after (num_layers - 1) layers, so the last
        layer never runs (the reference's patch_clip_for_lora exploits the
        same fact by truncating the encoder, utils/utils.py:264-282).
        """
        idx = self.feature_layer_idx
        if idx < 0:
            return self.num_layers + idx + 1
        return idx


@dataclass(frozen=True)
class RopeScalingConfig:
    """LongRoPE ("su") / yarn scaling (modeling_phi3_v.py:438-517)."""

    rope_type: str = "su"  # "su" | "yarn"
    short_factor: Tuple[float, ...] = ()
    long_factor: Tuple[float, ...] = ()


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder-only LM config (Phi-3 defaults, configuration_phi3_v.py:31-217).

    Weights keep the reference's fused layouts: qkv_proj packs
    [q; k; v] along the output dim and gate_up_proj packs [gate; up]
    (modeling_phi3_v.py:561-562,620-622) -- fused matmuls are also what the
    MXU wants.
    """

    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int = 4096
    rope_scaling: Optional[RopeScalingConfig] = None
    sliding_window: Optional[int] = None
    hidden_act: str = "silu"
    pad_token_id: int = 32000
    eos_token_id: int = 32000
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class Phi3VConfig:
    """Phi-3.5-vision-instruct backbone = CLIP tower + projector + Phi-3 LM.

    image_dim_out=1024, HD-transform 2x2 merge -> 4096-d features, 2-layer
    GELU MLP projector to hidden_size (modeling_phi3_v.py:160-180).
    """

    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    num_crops: int = 16  # HD-transform crop budget (processor pads to num_crops+1)
    image_dim_out: int = 1024

    @property
    def merged_feature_dim(self) -> int:
        return 4 * self.image_dim_out  # 2x2 spatial merge into channels


def phi35_vision_config() -> Phi3VConfig:
    """Full-size Phi-3.5-vision-instruct config.

    The su-rope factors match microsoft/Phi-3.5-vision-instruct's
    config.json (48 = head_dim/2 entries each).
    """
    short_factor = (
        1.08, 1.1, 1.1300000000000001, 1.2800000000000002, 1.3100000000000003,
        1.4500000000000004, 1.4500000000000004, 1.9500000000000008, 2.030000000000001,
        2.4299999999999926, 2.5699999999999896, 2.9499999999999815, 3.729999999999965,
        3.7399999999999649, 3.7599999999999642, 3.8399999999999625, 3.8499999999999623,
        3.9699999999999591, 4.0899999999999568, 4.2999999999999526, 4.4799999999999489,
        4.4999999999999485, 4.8999999999999397, 5.0999999999999361, 5.1199999999999357,
        5.1699999999999346, 5.2999999999999318, 5.4999999999999273, 5.5999999999999252,
        5.8999999999999186, 5.9699999999999171, 5.9699999999999171, 5.9899999999999167,
        6.0199999999999156, 6.0699999999999149, 6.0699999999999149, 6.0999999999999143,
        6.1099999999999136, 6.1599999999999126, 6.1699999999999124, 6.1899999999999119,
        6.2099999999999113, 6.2299999999999107, 6.2399999999999104, 6.2499999999999102,
        6.2599999999999096, 6.2699999999999096, 6.2799999999999087,
    )
    long_factor = (
        1.0800000429153442, 1.1100000143051147, 1.1399999856948853, 1.340000033378601,
        1.5899999141693115, 1.600000023841858, 1.6200000047683716, 2.620000123977661,
        3.2300000190734863, 3.2300000190734863, 4.789999961853027, 7.400000095367432,
        7.700000286102295, 9.09000015258789, 12.199999809265137, 17.670000076293945,
        24.46000099182129, 28.57000160217285, 30.420001983642578, 30.840002059936523,
        32.590003967285156, 32.93000411987305, 42.320003509521484, 44.96000289916992,
        50.340003967285156, 50.45000457763672, 57.55000305175781, 57.93000411987305,
        58.21000289916992, 60.1400032043457, 62.61000442504883, 62.62000274658203,
        62.71000289916992, 63.1400032043457, 63.1400032043457, 63.77000427246094,
        63.93000411987305, 63.96000289916992, 63.970001220703125, 64.02999877929688,
        64.06999969482422, 64.08000183105469, 64.12000274658203, 64.41000366210938,
        64.4800033569336, 64.51000213623047, 64.52999877929688, 64.83999633789062,
    )
    return Phi3VConfig(
        decoder=DecoderConfig(
            vocab_size=32064,
            hidden_size=3072,
            intermediate_size=8192,
            num_layers=32,
            num_heads=32,
            num_kv_heads=32,
            rms_norm_eps=1e-5,
            rope_theta=10000.0,
            max_position_embeddings=131072,
            original_max_position_embeddings=4096,
            rope_scaling=RopeScalingConfig(
                rope_type="su", short_factor=short_factor, long_factor=long_factor
            ),
            sliding_window=262144,
        ),
        vision=VisionConfig(),
        num_crops=16,
    )


def phi3v_tiny_config(
    num_layers: int = 2,
    hidden_size: int = 64,
    num_heads: int = 4,
    intermediate_size: int = 128,
    vision_layers: int = 2,
    vision_hidden: int = 32,
    vocab_size: int = 512,
    num_crops: int = 4,
) -> Phi3VConfig:
    """Tiny config for CPU tests: same topology, minuscule dims."""
    return Phi3VConfig(
        decoder=DecoderConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_layers=num_layers,
            num_heads=num_heads,
            num_kv_heads=num_heads,
            max_position_embeddings=4096,
            original_max_position_embeddings=4096,
            pad_token_id=vocab_size - 1,
            eos_token_id=vocab_size - 1,
        ),
        # image_size/patch_size stay at 336/14: the HD pipeline's crop size,
        # merge grid (24->12) and num_img_tokens formula are structural.
        vision=VisionConfig(
            hidden_size=vision_hidden,
            intermediate_size=vision_hidden * 4,
            num_layers=vision_layers,
            num_heads=4,
            image_size=336,
            patch_size=14,
        ),
        num_crops=num_crops,
        image_dim_out=vision_hidden,
    )


@dataclass(frozen=True)
class QwenVisionConfig:
    """Qwen2.5-VL vision tower (window-attention ViT, SwiGLU blocks,
    RMSNorm, 2D rotary). Defaults are the 7B checkpoint's values."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    in_channels: int = 3
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def win_patches(self) -> int:
        side = self.window_size // self.patch_size // self.spatial_merge_size
        return side * side * self.spatial_merge_size ** 2


@dataclass(frozen=True)
class QwenTextConfig:
    """Qwen2.5 decoder: GQA with q/k/v bias, separate gate/up SwiGLU,
    M-RoPE sections. Defaults: Qwen2.5-VL-7B-Instruct."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 128000
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: Optional[int] = None
    hidden_act: str = "silu"
    pad_token_id: int = 151643
    eos_token_id: int = 151645
    image_token_id: int = 151655

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class Qwen25VLConfig:
    text: QwenTextConfig = field(default_factory=QwenTextConfig)
    vision: QwenVisionConfig = field(default_factory=QwenVisionConfig)
    min_pixels: int = 256 * 28 * 28
    max_pixels: int = 1280 * 28 * 28


def qwen25_vl_7b_config() -> Qwen25VLConfig:
    return Qwen25VLConfig()


def qwen_tiny_config(
    num_layers: int = 2,
    hidden_size: int = 64,
    num_heads: int = 4,
    num_kv_heads: int = 2,
    vision_depth: int = 4,
    vision_hidden: int = 32,
    vocab_size: int = 512,
) -> Qwen25VLConfig:
    """Tiny CPU-test config; fullatt every other block to exercise both
    attention modes; head_dim 16 keeps mrope sections (4, 2, 2)."""
    return Qwen25VLConfig(
        text=QwenTextConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 2,
            num_layers=num_layers,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            mrope_section=(4, 2, 2),  # sums to head_dim//2 = 8
            pad_token_id=vocab_size - 1,
            eos_token_id=vocab_size - 1,
            image_token_id=vocab_size - 2,
        ),
        vision=QwenVisionConfig(
            depth=vision_depth,
            hidden_size=vision_hidden,
            intermediate_size=vision_hidden * 2,
            num_heads=4,
            out_hidden_size=hidden_size,
            fullatt_block_indexes=tuple(range(1, vision_depth, 2)),
        ),
        min_pixels=4 * 28 * 28,
        max_pixels=16 * 28 * 28,
    )


@dataclass(frozen=True)
class LlavaNextConfig:
    """LLaVA-v1.6: CLIP ViT-L/14-336 tower + anyres tiling + 2-layer GELU
    projector + a vicuna (llama) decoder. The decoder reuses the qwen text
    layer structure (separate q/k/v/gate/up, no biases, standard rope via a
    degenerate mrope section). Defaults: llava-v1.6-vicuna-13b
    (``config.py:350-378``)."""

    text: QwenTextConfig = field(
        default_factory=lambda: QwenTextConfig(
            vocab_size=32064,
            hidden_size=5120,
            intermediate_size=13824,
            num_layers=40,
            num_heads=40,
            num_kv_heads=40,
            rms_norm_eps=1e-5,
            rope_theta=10000.0,
            max_position_embeddings=4096,
            mrope_section=(64, 0, 0),  # head_dim 128 -> standard 1D rope
            pad_token_id=0,
            eos_token_id=2,
            image_token_id=32000,
        )
    )
    vision: VisionConfig = field(default_factory=VisionConfig)
    grid_pinpoints: Tuple[Tuple[int, int], ...] = (
        (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008),
    )
    projector_hidden_act: str = "gelu"


def llava_tiny_config(
    num_layers: int = 2,
    hidden_size: int = 64,
    num_heads: int = 4,
    vision_layers: int = 2,
    vision_hidden: int = 32,
    vocab_size: int = 512,
) -> LlavaNextConfig:
    return LlavaNextConfig(
        text=QwenTextConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 2,
            num_layers=num_layers,
            num_heads=num_heads,
            num_kv_heads=num_heads,
            rms_norm_eps=1e-5,
            rope_theta=10000.0,
            mrope_section=(hidden_size // num_heads // 2, 0, 0),
            pad_token_id=0,
            eos_token_id=2,
            image_token_id=vocab_size - 2,
        ),
        vision=VisionConfig(
            hidden_size=vision_hidden,
            intermediate_size=vision_hidden * 4,
            num_layers=vision_layers,
            num_heads=4,
            image_size=336,
            patch_size=14,
        ),
    )


@dataclass
class RewardConfig:
    """Reward-head configuration.

    The four persisted keys are exactly the public checkpoint contract
    (reward_config.yaml; deepspeed.py:402-404 / reward_adaptor_loader.py:25-30):
    is_general_preference, add_cross_attention, value_head_dim,
    general_preference_tau. The rest mirror the train-CLI flags
    (train_llava_reward.py:148-227).
    """

    is_general_preference: bool = False
    add_cross_attention: bool = False
    value_head_dim: int = 2
    general_preference_tau: float = 0.1

    # non-persisted behavioural knobs
    add_prompt_head: bool = False
    mean_hidden_state: bool = False
    layer_id: int = 32        # which decoder hidden state feeds the head
    vision_layer_id: int = -1  # reference quirk: vision embeds appended last

    def to_contract_dict(self) -> dict:
        """The four persisted keys of ``reward_config.yaml``."""
        return {
            "is_general_preference": bool(self.is_general_preference),
            "add_cross_attention": bool(self.add_cross_attention),
            "value_head_dim": int(self.value_head_dim),
            "general_preference_tau": float(self.general_preference_tau),
        }

    @classmethod
    def from_contract_dict(cls, d: dict, **extra) -> "RewardConfig":
        return cls(
            is_general_preference=bool(d["is_general_preference"]),
            add_cross_attention=bool(d["add_cross_attention"]),
            value_head_dim=int(d["value_head_dim"]),
            general_preference_tau=float(d["general_preference_tau"]),
            **extra,
        )
