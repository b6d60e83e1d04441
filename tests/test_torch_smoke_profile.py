"""chip_smoke.py's kernel times from the profiler, on the CPU.

`kernel_ms` times one launch of a kernel from torch.profiler over `reps`
calls of a function.  It counts the launches one call makes (the change
in the wrappers' launch counters, ops/cuda_lib.py:LAUNCHES, across an
unprofiled call) and reads a time only from a profile window whose rows
of the kernel count exactly `reps` times that many (device_rows with
that rule).  Every window opens with PROFILE_LEAD throwaway launches
(profile_window), whose rows are left out.  Any other window (short,
extra, empty) is reported on stderr and taken again, and a matching
window right after one that was not is taken again too; if no window is
kept within PROFILE_ATTEMPTS the time is None.  The reading itself is
held to nothing but its bound: under it, it fails its phase
(`under_bound`, `below_bound`).

The profiler is stubbed here: each window hands back the rows a test
scripts, and the card's synchronize and the throwaway launches do
nothing but record that they ran.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from opengl_raytracing_tpu_torch.ops import cuda_lib  # noqa: E402

KERNEL = cs.KERNELS["glass_mix"]["kernel"]
KEY = f"void (anonymous namespace)::{KERNEL}(Units, AnScene, GlassMixArgs)"
LEAD_KEY = f"at::cuda::(anonymous namespace)::{cs.LEAD_KERNEL}(long)"
US = 4.0  # a launch's device time in the scripted rows, microseconds


def _row(count, key=KEY, us=US):
    return SimpleNamespace(key=key, count=count, device_type=DeviceType.CUDA,
                           self_device_time_total=count * us)


class _Window:
    """A profile window that hands back `rows` and notes, in `log`, when
    it opens and closes."""

    def __init__(self, rows, log):
        self._rows, self._log = rows, log

    def __enter__(self):
        self._log.append("open")
        return self

    def __exit__(self, *exc):
        self._log.append("close")
        return False

    def key_averages(self):
        return self._rows


@pytest.fixture
def profiles(monkeypatch):
    """Installs a script of windows (a list of rows each, in the order
    they are taken); returns its state: the windows taken and a log of
    what ran, in order."""
    def install(script):
        state = SimpleNamespace(script=list(script), taken=0, log=[])

        def profile(*args, **kwargs):
            rows = state.script[state.taken]
            state.taken += 1
            return _Window(rows, state.log)
        monkeypatch.setattr(torch.profiler, "profile", profile)
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: state.log.append("sync"))
        monkeypatch.setattr(cs, "throwaway_launches",
                            lambda n: state.log.append(f"lead {n}"))
        return state
    monkeypatch.setitem(cuda_lib.LAUNCHES, "glass_mix", 0)
    return install


def _call(launches=1, log=None):
    """A call that launches the glass mix `launches` times, as its
    wrapper counts them."""
    def fn():
        cuda_lib.LAUNCHES["glass_mix"] += launches
        fn.calls += 1
        if log is not None:
            log.append("call")
    fn.calls = 0
    return fn


def test_a_matching_window_is_kept(profiles, capsys):
    state = profiles([[_row(5), _row(9, key="Memcpy HtoD")]])
    fn = _call()
    assert cs.kernel_ms(fn, KERNEL) == pytest.approx(US / 1e3)
    assert state.taken == 1
    # the counted call and device_rows' warm call, then the window's
    assert fn.calls == 2 + 5
    assert capsys.readouterr().err == ""


def test_each_window_opens_with_throwaway_launches(profiles):
    """The counted and warm calls run outside any window; each window
    opens with PROFILE_LEAD throwaway launches and a synchronize, then
    the timed calls and a synchronize."""
    state = profiles([[_row(4)], [_row(5)], [_row(5)]])
    cs.kernel_ms(_call(log=state.log), KERNEL)
    window = (["open", f"lead {cs.PROFILE_LEAD}", "sync"] + ["call"] * 5
              + ["sync", "close"])
    assert state.log == ["call", "sync"] * 2 + window * 3
    assert cs.PROFILE_LEAD > 0


def test_the_lead_launches_rows_are_left_out(profiles):
    """The throwaway launches' rows (torch.cuda._sleep's kernel) are no
    device row of the window: not in a count of launches, not beside a
    kernel."""
    profiles([[_row(cs.PROFILE_LEAD, key=LEAD_KEY), _row(5)]])
    rows = cs.profile_window(_call(), 5)
    assert [ev.key for ev in rows] == [KEY]
    profiles([[_row(cs.PROFILE_LEAD, key=LEAD_KEY), _row(5),
               _row(10, key="Memcpy HtoD")]])
    assert cs.launches_per_call(_call()) == 3


def test_the_launches_a_call_come_from_the_counters(profiles):
    # a call of two launches: 10 rows in 5 calls match, 5 do not
    state = profiles([[_row(5)], [_row(10)], [_row(10)]])
    assert cs.kernel_ms(_call(2), KERNEL) == pytest.approx(US / 1e3)
    assert state.taken == 3
    assert cs.kernel_launches(_call(3), KERNEL) == 3


@pytest.mark.parametrize("first", ["short", "extra", "empty"])
def test_a_window_that_miscounts_is_taken_again(profiles, capsys, first):
    """A window with fewer, more or no launches than it timed is printed
    with both counts and taken again; the matching window right after it
    is taken again too, and the next matching one is kept."""
    bad = {"short": [_row(4, us=1.0)], "extra": [_row(10, us=1.0)],
           "empty": []}[first]
    state = profiles([bad, [_row(5, us=2.0)], [_row(5)]])
    assert cs.kernel_ms(_call(), KERNEL) == pytest.approx(US / 1e3)
    assert state.taken == 3
    err = capsys.readouterr().err
    seen = {"short": 4, "extra": 10, "empty": 0}[first]
    assert f"profile 1 of {KERNEL} counted {seen} launches of it where 5 " \
        f"were timed" in err
    assert f"profile 2 of {KERNEL} follows one without its row: taken " \
        f"again" in err
    assert "profile 3" not in err


def test_a_matching_window_is_read_as_it_is(profiles, capsys):
    """A matching window's reading is kept whatever an earlier window
    read: two matching windows in a row are not held to agree."""
    state = profiles([[_row(6)], [_row(5, us=2.0)], [_row(5, us=9.0)]])
    assert cs.kernel_ms(_call(), KERNEL) == pytest.approx(9.0 / 1e3)
    assert state.taken == 3
    state = profiles([[_row(5, us=0.5)]])
    assert cs.kernel_ms(_call(), KERNEL) == pytest.approx(0.5 / 1e3)
    assert state.taken == 1


def test_a_window_that_sums_two_rows_of_the_kernel(profiles):
    """Two rows of one kernel (say its cubemap and gradient builds) are
    counted and timed together."""
    other = KEY.replace(KERNEL, KERNEL + "<true>")
    profiles([[_row(3), _row(2, key=other, us=9.0)]])
    assert cs.kernel_ms(_call(), KERNEL) == pytest.approx(
        (3 * US + 2 * 9.0) / 5 / 1e3)


def test_a_matching_window_after_each_miscount_is_not_kept(profiles,
                                                           capsys):
    """Every matching window follows one that miscounted (the card gave
    such a window, exact after one that counted 2 of 5, half the time the
    kernel takes alone): no reading is kept, the last window too."""
    script = [[_row(2)], [_row(5, us=2.0)]] * 3
    assert len(script) == cs.PROFILE_ATTEMPTS
    state = profiles(script)
    assert cs.kernel_ms(_call(), KERNEL) is None
    assert state.taken == cs.PROFILE_ATTEMPTS
    err = capsys.readouterr().err
    assert f"kernel_ms: {KERNEL} not measured" in err
    assert "[2, 5, 2, 5, 2, 5]" in err


def test_no_matching_window_is_not_measured(profiles, capsys):
    script = [[_row(4)], [], [_row(6)], [_row(4)], [], [_row(4)]]
    assert len(script) == cs.PROFILE_ATTEMPTS
    state = profiles(script)
    assert cs.kernel_ms(_call(), KERNEL) is None
    assert state.taken == cs.PROFILE_ATTEMPTS
    err = capsys.readouterr().err
    assert f"kernel_ms: {KERNEL} not measured: no profile of 6 counted the " \
        f"5 launches timed" in err
    assert "[4, 0, 6, 4, 0, 4]" in err


def test_windows_that_never_see_the_kernel_raise(profiles):
    profiles([[_row(5, key="Memset (Device)")]] * cs.PROFILE_ATTEMPTS)
    with pytest.raises(AssertionError, match="saw no launch"):
        cs.kernel_ms(_call(), KERNEL)


def test_a_call_that_launches_nothing_or_an_unknown_kernel_raises(
        profiles):
    profiles([[_row(5)]])
    with pytest.raises(AssertionError, match="launched 0"):
        cs.kernel_ms(_call(0), KERNEL)
    with pytest.raises(AssertionError, match="no launch counter"):
        cs.kernel_ms(_call(), "no_such_kernel")


@pytest.mark.parametrize("before", ["none", "agreeing", "twice_as_long"])
def test_a_kept_reading_under_its_bound_still_fails(profiles, before):
    """A reading kept from a matching window, under the call's bound, is
    picked by under_bound (as the phases an_gates, an_shade and hit_mix
    pick theirs) and fails the phase, whatever a matching window before
    it read (the card gave an_baseline's hit mix a reading under its
    bound in a matching window after a matching one that read twice as
    long)."""
    first = {"none": [], "agreeing": [[_row(6)], [_row(5, us=1.0)]],
             "twice_as_long": [[_row(6)], [_row(5, us=2.0)]]}[before]
    profiles(first + [[_row(5, us=1.0)]])
    got = cs.kernel_ms(_call(), KERNEL)
    assert got == pytest.approx(0.001)
    calls = [dict(bound_ms=0.0005, kernel_ms=0.0008),
             dict(bound_ms=0.002, kernel_ms=got)]
    over = cs.under_bound(calls, kernel="glass_mix", frame="an_full")
    assert over == [dict(kernel="glass_mix", frame="an_full", call=1,
                         bound_ms=0.002, kernel_ms=got)]
    with pytest.raises(AssertionError, match="below their bound"):
        cs.below_bound("an_shade", over)


def test_under_bound_keeps_the_fields_asked_and_skips_the_unmeasured():
    calls = [dict(bound_ms=0.002, kernel_ms=None, ao_radius=1.0),
             dict(bound_ms=0.002, kernel_ms=0.0, ao_radius=2.0),
             dict(bound_ms=0.002, kernel_ms=0.002, ao_radius=3.0),
             dict(bound_ms=0.002, kernel_ms=0.003, ao_radius=4.0)]
    assert cs.under_bound(calls, "ao_radius", kernel="an_ao") == [
        dict(kernel="an_ao", call=1, ao_radius=2.0, bound_ms=0.002,
             kernel_ms=0.0)]
    assert cs.under_bound(calls[2:]) == []
    cs.below_bound("an_gates", [])
