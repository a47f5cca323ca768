"""The flash backward's share of its roofline in the secure training cells."""
from chipbench.readers import flash_bwd_roofline as read  # noqa: F401
