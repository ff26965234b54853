"""Device ms a step of K2's backward (the kernels launched inside the
program's `op.k2.backward` ranges) in the traced steps."""


def read(facts):
    s = facts.get("trace")
    if s is None or not facts.get("steps") or not getattr(s, "items", 0):
        return None
    device_s = s.ranges.get("op.k2.backward", 0.0)
    return 1e3 * device_s / s.items if device_s > 0 else None
