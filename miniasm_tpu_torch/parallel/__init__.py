"""Sharded and multi-process paths over torch.distributed: the process
group (group.py), the K11 `route` kernel that buckets rows for an
all_to_all (route.py), the sharded select step and run_sharded (full.py),
and the multi-process worker (multihost.py)."""
