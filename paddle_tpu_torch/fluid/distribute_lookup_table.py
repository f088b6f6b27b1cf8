"""``fluid.distribute_lookup_table``
(``paddle_tpu/fluid/distribute_lookup_table.py``): finds the distributed
lookup-table op in a program — the PS transpiler's sparse-table
discovery."""


def find_distributed_lookup_table(program):
    """Return the table name used by distributed lookup_table ops (the
    is_distributed attribute contract), or None."""
    table = None
    for block in program.blocks:
        for op in block.ops:
            if op.type == "lookup_table" and op.attrs.get(
                    "is_distributed", False):
                w = op.inputs.get("W", [None])[0]
                if table is not None and w != table:
                    raise ValueError(
                        "all distributed lookup_table ops must share "
                        "one table; saw %r and %r" % (table, w))
                table = w
    return table
