"""Roofline of the port: the kernels' work counts (``counts``), the H100's
datasheet constants (``hw``), the op counter over a traced step on meta
tensors (``analysis``) and the dry-run tables (``report``)."""
