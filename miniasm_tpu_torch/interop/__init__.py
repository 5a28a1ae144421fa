"""Format interop converters mirroring the reference's misc/ scripts:
mhap2paf, da2paf, sam2paf, paf2mhap, wt2paf, paftop (reference
misc/*.pl, misc/*.js).  Each module is runnable:
`python -m miniasm_tpu_torch.interop.<name> [...]`.

The port's copies of miniasm_tpu/interop/."""
