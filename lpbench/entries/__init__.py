"""Found by name by ``lpbench.registry``."""
