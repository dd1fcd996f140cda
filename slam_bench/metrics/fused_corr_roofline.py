"""The fused correspondence kernel's share of its roofline: the frozen
bound of each launch in a slice (`roofline.kernel_bound_s`, from the
operands the wrapper saw) over the kernel's device time in the same
slice's trace, both as means a launch (a record the tracer dropped
counts in neither)."""

UNIT = "%"


def read(rec):
    r = rec["roofline"]
    if r is None or not r["recorded"] or r["kernel_s"] <= 0:
        return None
    seen = r["kept"][-1] * r["kernel_launches"]
    if seen <= 0:
        return None
    return 100.0 * (r["bound_s"] / r["recorded"]) / (r["kernel_s"] / seen)
