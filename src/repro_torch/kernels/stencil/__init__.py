"""5-point stencil kernels for the multigrid smoother."""
