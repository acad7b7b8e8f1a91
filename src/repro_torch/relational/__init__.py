"""Shard-local relational operators, the SPMD simulation and the exchange."""
