"""CFD substrate on torch tensors: space-tree layout, multigrid, Chorin
projection, the TRS scenarios and the snapshotting simulation driver."""
