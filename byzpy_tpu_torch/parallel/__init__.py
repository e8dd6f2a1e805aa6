"""Training rounds and the compressed wire fabric."""

from .collectives import reshard_q, reshard_q_ef
from .gossip import GossipStepConfig, build_gossip_train_step
from .ps import (
    SGD,
    Adam,
    PSStepConfig,
    adaptive_attack_rows,
    build_ps_train_step,
    build_ragged_serving_ps_step,
    build_serving_ps_step,
    default_optimizer,
    jit_ps_train_step,
    jit_ragged_serving_ps_step,
    jit_serving_ps_step,
)
from .quantization import (
    DEFAULT_BLOCK,
    SUB_INT8_MODES,
    CommPrecision,
    QuantizedBlocks,
    as_comm_precision,
    dequantize_blockwise,
    dequantize_rows,
    ef_encode,
    encode_blockwise,
    quantization_error_bound,
    quantize_blockwise,
)

__all__ = [
    "Adam",
    "DEFAULT_BLOCK",
    "SUB_INT8_MODES",
    "CommPrecision",
    "GossipStepConfig",
    "PSStepConfig",
    "QuantizedBlocks",
    "SGD",
    "adaptive_attack_rows",
    "as_comm_precision",
    "build_gossip_train_step",
    "build_ps_train_step",
    "build_ragged_serving_ps_step",
    "build_serving_ps_step",
    "default_optimizer",
    "dequantize_blockwise",
    "dequantize_rows",
    "ef_encode",
    "encode_blockwise",
    "jit_ps_train_step",
    "jit_ragged_serving_ps_step",
    "jit_serving_ps_step",
    "quantization_error_bound",
    "quantize_blockwise",
    "reshard_q",
    "reshard_q_ef",
]
