"""repro_torch.observability — dispatch log, tracing switch, convergence history."""
