"""Join algorithms (reference: src/joins/): the single-device m-way, m-pass
and mpsm count joins."""
