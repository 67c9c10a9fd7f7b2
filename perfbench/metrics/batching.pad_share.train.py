"""Share of the window's packed rows that are padding: 1 - real rows /
capacity rows, atoms, bonds and angles summed over every step's batch."""


def read(ctx):
    rows = ctx["window"]["rows"]
    cap = sum(r["atom_cap"] + r["bond_cap"] + r["angle_cap"] for r in rows)
    real = sum(r["atoms"] + r["bonds"] + r["angles"] for r in rows)
    return 100.0 * (1.0 - real / cap) if cap else None
