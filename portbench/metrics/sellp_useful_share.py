"""``sellp_useful_share``: the share of the SELL-P layout's stored slots that
hold an entry of the matrix, from the program's gauges
``sellp_true_nonzeros`` (the CSR entries converted) and
``sellp_stored_slots`` (what ``spmv_sellp`` streams), both set by the last
``sellp_from_csr_host`` in this process.  The rest is the slice padding.

It reads the layout, not the time: a layout that pads less moves it, a
faster kernel on the same layout does not.  Nothing off the card, or where
the program sets no such gauges."""

NAMES = ("sellp_true_nonzeros", "sellp_stored_slots")


def read(ctx):
    if ctx["device_kind"] is None:
        return None
    from repro_torch.observability import metrics

    got = {s["name"]: s["value"] for s in metrics.samples()
           if s["name"] in NAMES and not s["labels"]}
    if len(got) < 2 or not got["sellp_stored_slots"]:
        return None
    return got["sellp_true_nonzeros"] / got["sellp_stored_slots"]
