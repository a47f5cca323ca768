"""The step's share of the bf16 peak in the plain training cells."""
from chipbench.readers import step_mfu as read  # noqa: F401
