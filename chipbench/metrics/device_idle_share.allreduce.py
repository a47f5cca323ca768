"""The device's idle share in the allreduce cells (allreduce_gelem_per_s)."""
from chipbench.readers import device_idle_share as read  # noqa: F401
