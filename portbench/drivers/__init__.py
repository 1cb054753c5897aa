"""Drivers: the loops that hand a cell's traffic to the program.

A traffic mix names its driver under ``"driver"``; the harness loads
``drivers/<driver>.py`` (:func:`portbench.common.driver`) and calls its
three functions, in this order, from :func:`portbench.cell.run`. A new
driver is a new file here; no file of the harness changes.

``build(ctx) -> state``
    Set-up: the program's objects made from the traffic, and every shape
    the window will use run once, so that nothing builds, compiles or
    captures inside the window. Counted in ``setup_s``. ``ctx`` holds
    ``cfg`` (the configuration), ``mix`` (the traffic mix), ``traffic``
    (:class:`portbench.generator.Traffic`), ``where`` (a ``torch.device``,
    or a mesh when ``mix["devices"]`` > 1), ``seconds`` (the window's
    length), ``spans`` (:class:`portbench.tracing.Spans`, the harness's
    host spans) and ``traced`` (whether a profiler is on).

``window(state, ctx) -> dict``
    The measured window: calls into the program for ``ctx.seconds``
    seconds, one caller, and waits for every answer it issued. Returns

    * ``window_s``: the window's seconds on the host clock, first call to
      last answer;
    * ``items``: one dict per unit of work answered (a group, a request),
      in order. Each carries ``pair_hours``, the hours of the episodes the
      item answered × the queries it answered them for, which
      ``pair_hours_per_s`` sums; a driver's own per-layer readers may read
      further keys;
    * ``answers``: (item index, episode, query, [(position, height,
      prominence)]) for every (episode, query) the window answered, as the
      program returned them (:func:`portbench.check.as_triples`);
    * ``seen``: the episode indices the window answered, among which the
      check draws its sample;
    * ``graph``: the program's ``StepGraphs.stats`` over the window
      (after minus before), ``{}`` where it graphs nothing.

``release(state)``
    Frees what ``state`` holds on the device beyond the caller's
    reference, before the reference runs.
"""
