"""Episode hours × queries of every item the window answered, over the
window's seconds: what an archive sweep feels, and for one caller's loop
of single files the inverse of the mean wait (1 h ÷ the mean latency of
a 1 h episode against one query). Read from any driver's window
(``portbench/drivers/__init__.py``); nothing where no item carries
``pair_hours``."""


def read(run):
    hours = [i["pair_hours"] for i in run.items if "pair_hours" in i]
    if not hours:
        return None
    return sum(hours) / run.window_s
