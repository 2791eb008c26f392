"""Launch layer of the port: the mesh, input shapes, the plan, the train
and serve steps, the train loop and the serve loop (the PyTorch
counterpart of the JAX package's ``launch/``).

  mesh    ``make_host_mesh`` (one card, or the CPU when asked) and
          ``make_production_mesh`` (a shape for planning, no devices)
  shapes  ``input_specs`` (the batch tree as ``meta`` tensors) and
          ``make_batch`` (drawn from a ``torch.Generator``)
  train   ``plan_for_mesh`` (the SAMO plan of one cell on a mesh) and
          ``train``: the train loop (data, AdamW, checkpoints, restart
          from the latest); ``python -m repro_torch.launch.train``
  steps   ``shard_fns_from_plan``, ``make_train_step`` (loss, grads,
          AdamW), ``make_serve_step`` (prefill and decode against a
          cache), the weight-streaming steps of one partition of a plan
          (``make_partition_train_step``, ``make_partition_serve_step``)
          and the specs (``zero1_specs``, ``opt_state_specs``,
          ``batch_shardings``); sharded steps on a mesh of more than one
          device are ROADMAP Queue 1 item 15
  serve   ``serve`` and ``generate``: prefill, then greedy decode, on any
          plan (partition 0's steps over the whole model, as JAX's);
          ``python -m repro_torch.launch.serve``
"""
