"""API adapters: gymnasium, dm_env and the functional handle."""
