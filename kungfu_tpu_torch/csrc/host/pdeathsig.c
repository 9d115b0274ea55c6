/* kf-pdeathsig: exec shim arming PR_SET_PDEATHSIG before the worker runs.
 *
 * Orphan protection for spawned workers: a hard-killed runner (SIGKILL,
 * OOM) never reaches its cleanup, and calling prctl from a Python
 * preexec_fn is unsafe in a threaded runner (the forked child can
 * deadlock on locks held by threads that no longer exist). A fresh
 * single-threaded C process has no such hazard: arm the death signal,
 * re-check the parent is still alive (the arm is useless if the runner
 * died during our exec), then become the worker via execvp. The setting
 * survives execvp.
 *
 * Usage: kf-pdeathsig <cmd> [args...]
 *
 * The port's copy of native/pdeathsig.c, built at first use by
 * kungfu_tpu_torch/ops/_build.py::compile_pdeathsig.
 */
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <sys/prctl.h>
#include <unistd.h>

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: kf-pdeathsig <cmd> [args...]\n");
        return 2;
    }
    prctl(PR_SET_PDEATHSIG, SIGTERM);
    /* Died-before-arm race: compare against the EXPLICIT runner pid
     * (KF_RUNNER_PID, set by WorkerProc). A getppid()==1 heuristic would
     * misfire when the runner itself is PID 1 (container entrypoint) or
     * under a subreaper. No env -> skip the check; the arm alone still
     * protects every later death. */
    const char *rp = getenv("KF_RUNNER_PID");
    if (rp && atoi(rp) > 0 && getppid() != atoi(rp)) {
        return 0; /* runner died before the arm: don't start an orphan */
    }
    execvp(argv[1], &argv[1]);
    perror("kf-pdeathsig: execvp");
    return 127;
}
