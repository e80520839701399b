"""Per-layer metric readers, one module a quantity, named after it (a
metric `<quantity>.<variant>` is the quantity in the cells of one
end-to-end metric). Each declares LAYER, UNIT, SOURCE and MOVES (the
end-to-end quantity it moves) and has `read(ctx)`, which returns the
metric or None when the traced window holds nothing to read."""
