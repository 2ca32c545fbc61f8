"""Language models of the silo path: configuration, parameters, the
prefill forward and the KV-cache decode (dense family)."""
