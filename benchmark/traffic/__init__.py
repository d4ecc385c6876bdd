"""Traffic mixes (``<name>.json``) and their one generator."""
