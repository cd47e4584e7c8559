"""Workloads built on the port: the long-context GQA attention block
(``long_context``)."""
