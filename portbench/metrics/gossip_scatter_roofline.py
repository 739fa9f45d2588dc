"""gossip_scatter_roofline: a sampled round's write-back kernel against
its byte bound (the participants' buffer and momentum rows,
`kernel_bytes.scatter`)."""
from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, "gossip_scatter")
