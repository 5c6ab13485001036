"""The native witness replay (the JAX package's ``native/``): the C VM
``csrc/witgen.c`` (``engine``), the lowering of generators to its
instructions (``lower``) and the recorded schedules (``schedule``)."""
