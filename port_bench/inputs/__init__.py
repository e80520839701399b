"""Generators of the jobs' initial fields, one module a kind, named by a
cell's `inputs`. Each makes one pool entry on the device from the seed and
the entry's index; the program and the reference get the same arrays."""
