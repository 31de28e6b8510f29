"""The NAM-DB protocol core: headers, CAS, MVCC, oracle, index, SI."""
