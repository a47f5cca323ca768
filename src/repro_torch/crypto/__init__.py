"""Protocol-scale cryptography of the port: limb helpers and threshold
Paillier, whose partial decryptions run on the Montgomery-multiply
kernel."""
