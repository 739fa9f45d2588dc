"""gossip_gather_roofline: the mix's gather kernel against its byte bound
(the participants' rows read once and written once, `kernel_bytes.gather`)."""
from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, "gossip_gather")
