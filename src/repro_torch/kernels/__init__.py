"""Kernels of the LM stack and their oracles.

  ref.py              plain PyTorch oracles (GQA attention, its chunked
                      online-softmax form, the WKV recurrence with a
                      carried state); each kernel's plain version is one
  flash_attention.py  the flash-attention kernel's wrapper
                      (``csrc/flash_attn.cu``)
  rwkv6_scan.py       the RWKV6 WKV kernel's wrapper (``csrc/wkv6.cu``)
  ops.py              the layout wrappers the models call
"""
