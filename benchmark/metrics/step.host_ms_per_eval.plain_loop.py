"""``step.host_ms_per_eval`` in the cells whose training step runs the
plain loop: the same reading, beside their own end-to-end
``train_eval_ms.plain_loop``."""

import harness


def read(ev):
    return harness.reader("step.host_ms_per_eval").read(ev)
