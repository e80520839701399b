"""End-to-end metric readers, one module a quantity, named after it (a
metric `<quantity>.<variant>` is the quantity in one family's cells, so
that each family has its own bound). Each declares UNIT and has
`read(window)` over the closed loop's record (harness/loop.py::Window)."""
