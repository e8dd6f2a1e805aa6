"""The actor layer (counterpart of ``byzpy_tpu/engine/actor``): so far the
compressed wire rows that the serving tier's quantized cohorts read."""
