"""The least work of one job (a forward and an inverse transform), one
module a transform family, found by the name a configuration's ``family``
gives.  Counted from the transform's shapes, not from the kernels that
happen to run, so a change to the kernels leaves the yardstick where it
was."""
