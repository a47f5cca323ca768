"""The device's idle share in the secure training cells (train_tokens_per_s)."""
from chipbench.readers import device_idle_share as read  # noqa: F401
