"""Kernels of the LM stack and their oracles.

  ref.py          plain PyTorch oracles (the WKV recurrence, with a carried
                  state); each is the plain version of a hand-written kernel
  rwkv6_scan.py   the RWKV6 WKV kernel's wrapper (``csrc/wkv6.cu``)
  ops.py          the layout wrappers the models call

Flash attention (the JAX package's second LM kernel) is not ported yet.
"""
