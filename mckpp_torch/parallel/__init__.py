"""Column-axis parallelism over processes (``distributed``) and its padding (``sharding``)."""
