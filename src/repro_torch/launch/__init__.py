"""Regime B (port of `repro/launch`): DFedPGP rounds on m clients of a
transformer LM, each client a full personalized model whose shared body
gossips over the run's one `TopologySchedule` while `lm_head` and
`final_norm` stay personal.

  mesh    mesh descriptions (axis names and sizes), `client_layout`, and
          the one-device layout `train.py` runs on
  steps   `Layout` / `decide_layout`, the input structs (meta tensors),
          `build_train_algo` and the `build_*_step` functions of the
          train / prefill / decode steps
  train   `python -m repro_torch.launch.train`: the runnable trainer

One card is one device: every client lives on it, the gossip is the
matrix mix (the `gossip_gather` kernel on the resident buffer), and the
sharding entries of the `build_*_step` tuples are None.  The reference's
multi-device half (`shard_map` + `ppermute` mixes, `sharding.py`,
`dryrun.py`) is ROADMAP item 14b.
"""
