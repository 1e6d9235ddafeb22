"""The DES baseline.  The reference package has no ``des/__init__.py``; this
empty one makes ``repro_torch.des`` a regular package, so that walking the
port's packages reaches ``des.simulator``."""
