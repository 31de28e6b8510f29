"""TPC-C over the NAM store."""
