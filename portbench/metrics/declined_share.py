"""declined_share: the share of lossy fields that the device encoder sent
to the host coder, from the program's counter of declines by reason
(`core/device_encode.DECLINES`), summed over reasons, over the window."""


def read(ctx):
    if not ctx["lossy_fields"]:
        return None
    return 100.0 * ctx["declines"] / ctx["lossy_fields"]
