"""The degradations module under its old, misspelled name.

Counterpart of ``prysm_tpu/degredations.py``: code written against prysm
releases that shipped ``degredations`` imports it unchanged.
"""
from .degradations import *  # NOQA
from .degradations import jitter_ft, smear_ft  # NOQA
