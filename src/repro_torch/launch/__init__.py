"""Regime B (port of `repro/launch`): DFedPGP rounds on m clients of a
transformer LM, each client a full personalized model whose shared body
gossips over the run's one `TopologySchedule` while `lm_head` and
`final_norm` stay personal.

  mesh     mesh descriptions (`MeshSpec`, the production meshes),
           the client mesh over the ranks of a process group
           (`make_host_mesh`), `client_layout` and the one-device layout
  ranks    the process-group setup (NCCL on the card, gloo on the CPU,
           a file rendezvous) and the row plans of the cross-rank mixes
  sharding the reference's placement rules as tuples
  tp       tensor parallelism across a client mesh's 'model' group: the
           shard plan, the conjugate collectives, the vocab-parallel
           embedding and cross-entropy, a rank's share of the round
  steps    `Layout` / `decide_layout`, the input structs (meta tensors),
           the placements, the cross-rank mixes, `build_train_algo` and
           the `build_*_step` functions of the train / prefill / decode
           steps
  train    `python -m repro_torch.launch.train`: the runnable trainer,
           on one device or over `--ranks W` processes
  dryrun   `python -m repro_torch.launch.dryrun`: bytes per device, wire
           bytes and FLOPs of every arch x shape on the production meshes
  ranks_check  the cross-rank mixes and rounds on arrays from files over
           W spawned ranks (what the tests hold against the reference)

On one device every client lives on it and the gossip is the matrix mix
(the `gossip_gather` kernel on the resident buffer).  Across the ranks of
a (data, model) client mesh each data index holds a contiguous block of
clients, its model ranks split those clients' models (every family;
`tp.py`), and the mixes exchange the rows that cross data
indices among the ranks of one model index.
"""
