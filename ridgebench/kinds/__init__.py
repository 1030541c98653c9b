"""Traffic kinds: one module each, named by a traffic file's ``kind``.

A kind's ``Cell(doc, traffic, seed, device)`` does the set-up (weights
drawn from the seed, every shape of the cell warmed up); ``unit(i)`` runs
one unit of the window's work and returns when the device has finished it;
``end_to_end(seconds, window_s)`` gives the kind's end-to-end metrics from
each unit's host seconds and the window's; ``work()`` the model work of one
unit for the per-layer metrics; ``check()``, once the window has closed,
the numbers that decide ``correct`` (it frees the program's state and runs
the plain reference); ``faults`` the ways the tests break its timed path.
"""
