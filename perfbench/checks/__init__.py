"""Checks beyond the judge's own numbers, one module per check, found by
the numbers a cell's limits file names (harness/spec.py `checks_for`).

A key of perfbench/limits/<cell>.json that harness/judge.py does not form
is looked up in the `NUMBERS` of these modules; the one module that names
it is the cell's check, and a key that none names stops the run in
set-up. `<check>.py` defines:

- `NUMBERS`: the names of the numbers it forms;
- `CAPTURES`: ((module, attribute), ...), the program's functions whose
  calls it reads. In a cell whose limits name one of its numbers, the
  probes wrap each (harness/probes.py) and restore it after the window;
- `keep(scan_index, sample, args, kwargs, result)`: called after each
  wrapped call in a session started with `capture`, with the scan being
  processed (-1 outside a scan), the set of sampled scans, and the call's
  arguments and result. It returns what the check needs of the call,
  copied, or None to keep nothing. What it returns goes, in call order,
  to the session's `checks[<check>]`;
- `readings(captured, cfg, traffic, device) -> {number: float}`: the
  numbers over what the judged session kept (`captured`, [] where it kept
  nothing), the configuration file as run (`cfg`, a dict), the traffic
  (harness/traffic.Traffic) and the cell's device. A number that cannot
  be formed is inf;
- `control(captured, cfg, traffic, device) -> {number: float}`: the same
  numbers with the reference one precision below the stated one put in
  the program's place, from which, with the readings, its limits are set.

Checks run after the window, the built-in readings and the program's
state freed, outside every timed number; a reference may use the device
(with TF32 off where it states float32). The result's `checked` block
holds each compared number beside its limit, in the order of the names.
"""
