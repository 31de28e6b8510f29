"""K5 corpus: kernel packages whose ops/ref pairs drifted out of lock step.

Like the JAX package's K5 corpus these are SOURCE PAIRS, not importable
kernels: K5 is a pure-AST check, so the corpus feeds
``kernel_audit.check_ref_parity_sources`` synthetic ops.py/ref.py texts:
a kernel without its entry point, a missing ``_ref`` twin, a positional
signature mismatch, a twin-only keyword (the drift the port carries on
purpose at ``mamba_scan``, suppressed there with its reason), and a pair
registered in only one of the two test files. Do not fix:
tests/test_torch_analysis.py asserts each fires.
"""

OPS_NO_ENTRY = '''
def prepare(table, keys):
    return table
'''
REF_NO_ENTRY = '''
def lookup_ref(table, keys):
    return table
'''

OPS_MISSING_REF = '''
def lookup(table, keys, *, max_probes=16):
    return table, keys
'''
REF_MISSING_REF = '''
def _helper(x):
    return x
'''

OPS_SIG_DRIFT = '''
def commit(headers, slots, expected):
    return headers
'''
REF_SIG_DRIFT = '''
def commit_ref(headers, requests, expected):
    return headers
'''

OPS_KW_DRIFT = '''
def scan(dt, x, *, chunk=64):
    return x
'''
REF_KW_DRIFT = '''
def scan_ref(dt, x, *, h0=None):
    return x
'''

OPS_GOOD = '''
def probe(table, keys, *, max_probes=16):
    return table
'''
REF_GOOD = '''
def probe_ref(table, keys, *, max_probes=16):
    return table
'''

# test sources that register every _ref above (the cross-package one) and
# probe_ref alone (the card one)
CROSS_TESTS = '''
from ref import lookup_ref, commit_ref, scan_ref, probe_ref
'''
GPU_TESTS = '''
from ref import probe_ref
'''
