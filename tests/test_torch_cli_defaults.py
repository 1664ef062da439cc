"""The port's CLIs parse like the reference's.

Each CLI's ``main`` is called with the same argv in both packages, and
``argparse.ArgumentParser.parse_args`` is patched to raise a sentinel that
carries the parsed namespace, so nothing runs.  Every option both parsers
have must default (and parse) the same, except the port's recorded
deliberate differences (ROADMAP queue 3), listed here.
"""
import argparse

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.launch.serve as ref_serve  # noqa: E402
import repro.launch.train as ref_train  # noqa: E402
import repro_torch.launch.serve as port_serve  # noqa: E402
import repro_torch.launch.train as port_train  # noqa: E402

# option -> (reference's value, port's value) that may differ, and why
DELIBERATE = {
    # one process with no --mesh trains without a process group; the
    # (1, 1) debug mesh is bit-equal to it
    "mesh": ("debug", None),
}
# the port's reassembly names for the reference's
REASSEMBLY = {"xla": "torch", "pallas": "kernel"}
PORT_ONLY = {"device"}        # the port runs on the card unless told


class Parsed(Exception):
    pass


@pytest.fixture
def capture(monkeypatch):
    parse = argparse.ArgumentParser.parse_args

    def raise_namespace(self, args=None, namespace=None):
        raise Parsed(parse(self, args, namespace))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        raise_namespace)

    def run(main, argv):
        with pytest.raises(Parsed) as got:
            main(argv)
        return vars(got.value.args[0])
    return run


@pytest.mark.parametrize("cli,argv", [
    ("train", []), ("train", ["--mode", "sim", "--epochs", "2"]),
    ("train", ["--elastic", "--multi-pod", "--steps", "5"]),
    ("train", ["--reassembly", "pallas"]),
    ("serve", []), ("serve", ["--engine", "continuous", "--gen", "4"]),
])
def test_cli_defaults_equal_the_reference(capture, cli, argv):
    ref_mod, port_mod = {"train": (ref_train, port_train),
                         "serve": (ref_serve, port_serve)}[cli]
    ref = capture(ref_mod.main, argv)
    port_argv = [REASSEMBLY.get(a, a) for a in argv]
    port = capture(port_mod.main, port_argv)
    assert set(port) - set(ref) == PORT_ONLY
    assert set(ref) <= set(port)
    for key, want in ref.items():
        got = port[key]
        if key == "reassembly":
            want = REASSEMBLY[want]
        if key in DELIBERATE and (want, got) == DELIBERATE[key]:
            continue
        assert got == want, (cli, key, want, got)
