"""Traffic kinds of their own, one file each: ``<kind>.py`` with
``make(mix, rng)``.

A mix whose ``kind`` is not one of ``generate.py``'s built-in kinds names a
file here. ``make`` gets the mix's parameters (``traffic/<mix>.json``) and
the run's ``numpy.random.Generator``, draws one call's inputs from it, and
returns a ``generate.SWPairs`` or a ``generate.PHMMRegions`` in plain bytes.
``generate.sets`` calls it once an input set, on one generator, so that a
run's sets follow one another. Like the built-in kinds, a kind gives every
seed the same sizes and cells, and the seed changes only which residues or
bases are scored and in what order.
"""
