"""The sequence models' recurrences over time: kernel L (Mamba's
selective scan, ``selective_scan.py``) and kernel M (RWKV-6's wkv,
``wkv6.py``), each with its plain version.  The power path's scans (B, C,
D, J, K) keep their wrappers in ``core/``; all their sources are in
``csrc/``."""
