"""The flash backward's share of its roofline in the plain training cells."""
from chipbench.readers import flash_bwd_roofline as read  # noqa: F401
