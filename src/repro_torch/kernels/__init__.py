"""Hand-written Hopper kernels of the port and their plain torch versions;
``backend`` picks one of the two per call from the tensor's device."""
