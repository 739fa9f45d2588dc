"""Algorithm core of the port: partition, topology, gossip, local steps
and the resident DFedPGP round."""
