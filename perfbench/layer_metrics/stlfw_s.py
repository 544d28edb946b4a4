"""Host seconds of the port's ``learn_topology`` in set-up."""


def read(out, ctx):
    return out.layer.get("stlfw_s")
