"""Device ms a GAN step in convolution kernels and the layout transposes around them (``drivers/gan_train.CONV_RE``), over the steps completed in the window."""


def read(rec):
    spent, steps = rec.get("conv_device_s"), rec.get("steps")
    if not spent or not steps:
        return None
    return 1e3 * spent / steps
