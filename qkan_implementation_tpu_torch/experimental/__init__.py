"""Experimental modules, on torch tensors.

Counterpart of ``qkan_implementation_tpu.experimental``: nothing here is
selected by a production path.
"""
