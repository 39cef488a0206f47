"""The benchmark of riptrm_torch (see README.md): one general runner
(``harness.py``) reading data files and small per-name modules."""
