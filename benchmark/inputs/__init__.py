"""Inputs beyond the premixed table, one module per configuration that
needs them.

A configuration file may hold ``"inputs": "<module>"``; it names
``benchmark/inputs/<module>.py``, which has one function::

    make(cfg, table_fields, tmpdir, device) -> dict

``cfg`` is the configuration as it is run (its ``helios`` fields with the
precision the run uses), ``table_fields`` the premixed table's fields
(``frozen.table.make_table``), ``tmpdir`` a directory of the run for the
files the module writes, ``device`` the program's device.  It returns
two keys:

- ``program``: keyword arguments of every call of the entry points,
  ``pipeline.run`` and ``run_ensemble`` alike, such as ``sset=``, a
  species set built through the program's own ``chem.build_species_set``;
- ``reference``: plain arrays (numpy or torch, nothing of the program)
  that the configuration's reference finds in its table argument beside
  the table's fields, such as each species' table, VMR table and
  Rayleigh cross-section.

``drive.Program`` calls it once, before the warm call, so its time counts
in ``setup_s``.  ``HeliosConfig`` fields of such a configuration, such as
``opacity_mixing``, stand in its own ``helios``, where the judge and the
record read them too."""
