# coding: utf-8
"""Data parallelism: one process per card (``parallel.distributed``)."""
