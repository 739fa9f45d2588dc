"""Round drivers, one module per regime, found by a configuration's
`regime` key.  Each module defines `Cell(config, traffic, seed, device)`
(`common.DFedPGPCell`'s interface): set-up through the checked rounds,
then `plan(r)` / `dispatch(plan)` per round, the reference's readings
after `release()`."""
