"""``step_mfu`` in the cells whose training step runs the plain loop
(every family but SE-iso): the same reading, beside their own end-to-end
``train_eval_ms.plain_loop``."""

import harness


def read(ev):
    return harness.reader("step_mfu").read(ev)
