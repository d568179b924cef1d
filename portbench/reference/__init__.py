"""Plain float64 references of the benchmark's transform families, one
module a family (``dwt2``, ``dwt3``), found by the name a configuration's
``family`` gives.  They import ``torch`` and nothing of the program."""
