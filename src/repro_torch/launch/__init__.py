"""Launch layer of the port: the mesh, input shapes, the plan, the serve
steps and the serve loop (the PyTorch counterpart of the JAX package's
``launch/``).

  mesh    ``make_host_mesh`` (one card, or the CPU when asked) and
          ``make_production_mesh`` (a shape for planning, no devices)
  shapes  ``input_specs`` (the batch tree as ``meta`` tensors) and
          ``make_batch`` (drawn from a ``torch.Generator``)
  train   ``plan_for_mesh`` (the SAMO plan of one cell on a mesh); the
          training loop is ROADMAP Queue 1 item 14
  steps   ``shard_fns_from_plan`` and ``make_serve_step`` (prefill and
          decode against a cache); the train and weight-streaming steps are
          item 15
  serve   ``serve`` and ``generate``: prefill, then greedy decode;
          ``python -m repro_torch.launch.serve``
"""
