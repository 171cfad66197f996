"""``device_idle_pct.train`` in the cells whose training step runs the
plain loop: the same reading, beside their own end-to-end
``train_eval_ms.plain_loop``."""

import harness


def read(ev):
    return harness.reader("device_idle_pct.train").read(ev)
