"""Drivers: what the benchmark knows of one kind of program.

A configuration file under ``configs/`` names its driver (``"driver":
"drivers/<name>.py"``) and its plain reference (``"reference"``), both as
paths under ``perfbench/``.  ``harness.run`` imports the driver by its
module path and calls, in this order:

- ``Program(spec, seed, device, fault=None)``: the system under test set
  up from the seed for the cell ``spec`` (``harness.cell_spec``), its
  set-up phases' clock readings in ``times``, and ``feed``, a
  ``harness.Feed`` over the stream that the timed entry draws from.
  ``fault`` plants a fault in the timed path, for the tests.
- ``first_steps()``: the checked first steps through the feed; returns
  the program's readings for ``check``, and sets ``first_rows`` (the
  rows of those steps) and ``last_step_s`` (the wall time of the last).
- ``warm_buckets(steps)``: runs every shape that the next ``steps``
  draws reach and the first steps did not; returns the shapes run.
- ``train(items)``: the timed entry, over items drawn from ``feed``.
- ``report()``: one line on the set-up; ``close()``.
- ``evidence()``: what the check needs once the program is freed.

and, at module level, ``shape(rows)`` (the shape a batch of those rows
runs at), ``CHECKS`` (the names of the numbers that ``check`` returns:
a cell's limits file names exactly these) and ``check(spec, evidence,
readings, device)``, which runs the reference and returns those
numbers.  Each batch's rows are a dict that holds at least
``"crystals"``, the samples that the end-to-end rate counts, and the
keys that the cell's per-layer metrics read.
"""
