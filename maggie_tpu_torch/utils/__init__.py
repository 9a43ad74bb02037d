"""Weight utilities of the port: spectral-norm folding and weight conversion."""
