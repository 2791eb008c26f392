"""Launch layer of the port: the mesh, input shapes, the plan, the train
and serve steps, the train loop and the serve loop (the PyTorch
counterpart of the JAX package's ``launch/``).

  mesh    ``make_host_mesh`` (one card, or the CPU when asked),
          ``make_production_mesh`` (a shape for planning, no devices),
          ``make_mesh`` over a process group (``init_process_group``:
          nccl on cards, gloo on the CPU) and ``make_fake_mesh`` (the
          production shape on a fake group of 512 ranks)
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
          ``batch_shardings``); on a process group's mesh they run on
          DTensors laid out from the plan (the rwkv, ssm and
          encoder-decoder kinds: ROADMAP Queue 1 item 15)
  serve   ``serve`` and ``generate``: prefill, then greedy decode, on any
          plan (partition 0's steps over the whole model, as JAX's);
          ``python -m repro_torch.launch.serve``
  dryrun  every (arch x shape x mesh) cell's sharded steps run on fake
          tensors over the fake group, each device's FLOPs, bytes,
          collectives and peak memory counted, the H100 roofline;
          ``python -m repro_torch.launch.dryrun``
"""
