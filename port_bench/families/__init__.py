"""The system under test, one module a solver family, named by a
configuration's `family`. Each builds the family's entry from a config
and a cell and runs one job of the closed loop (harness/loop.py)."""
