"""The flash forward's share of its roofline in the secure training cells."""
from chipbench.readers import flash_fwd_roofline as read  # noqa: F401
