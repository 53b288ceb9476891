"""Device milliseconds a pass of the intersection kernels, found by name:
K1 and K2 (`traverse_kernel`, `csrc/bvh_traverse.cu`) and K-prim
(`prim_closest_hit_kernel`, `prim_any_hit_kernel`, `csrc/prim_hit.cu`).
`dense_tri_hit`'s torch chain has no kernel of its own and is not in it."""

NAMES = ("traverse_kernel", "prim_closest_hit_kernel", "prim_any_hit_kernel")


def read(rec):
    ours = [(s, e) for name, s, e in rec["kernels"] if any(n in name for n in NAMES)]
    if not ours or not rec["passes"]:
        return None
    return sum(e - s for s, e in ours) / 1e6 / rec["passes"]
