"""The plain reference: DFedPGP's rounds and the models, written in plain
PyTorch from the published descriptions.  It imports nothing of the
program (`repro_torch`) nor of the JAX package; it is given the inputs
the benchmark made (weights, data, tables, participants, minibatches)
and works out everything else itself: the induced tables, the steps,
the mix and the state."""
