"""Device ms a GAN step in the optimizers' foreach kernels: the global norms and the clip, AdamW of both nets, the discriminator's update guard and the EMA (``drivers/gan_train.OPTIMIZER_RE``)."""


def read(rec):
    spent, steps = rec.get("optimizer_device_s"), rec.get("steps")
    if not spent or not steps:
        return None
    return 1e3 * spent / steps
