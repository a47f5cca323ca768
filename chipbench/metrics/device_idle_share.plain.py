"""The device's idle share in the plain training cells (train_tokens_per_s.plain)."""
from chipbench.readers import device_idle_share as read  # noqa: F401
