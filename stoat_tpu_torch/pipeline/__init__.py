"""Device pipeline of the port: packed membership, binary tables, result
fetch and the VCF runner."""
