"""``format_setup_s``: host clock around the format conversion the
configuration names (``ell_from_csr_host``, ``sellp_from_csr_host``: the
host padding and the copy to the device), synchronised at both ends."""


def read(ctx):
    return ctx["spans"].get("format")
