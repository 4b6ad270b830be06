// nsexec — minimal namespace-isolation shepherd for the exec driver.
//
// The reference isolates exec/java tasks with libcontainer plus an embedded
// nsenter C shim re-exec'd as a subprocess (drivers/shared/executor/
// executor_linux.go:29, libcontainer_nsenter_linux.go). This is the same
// role as a single small C++ binary: it creates fresh PID / mount / IPC /
// UTS namespaces, makes the mount tree private, mounts a namespace-local
// /proc, then supervises the task as the namespace's init — forwarding
// SIGTERM/SIGINT and propagating the task's exit status to the driver.
//
// usage:
//   nsexec --check                     exit 0 iff isolation is available
//   nsexec [--workdir D] [--hostname H] [--cgroup NAME] [--chroot D]
//          [--memory-mb N] [--cpu-shares N] [--seccomp default]
//          -- cmd [args...]
//
// --seccomp default installs a fixed-BPF syscall denylist (no libseccomp;
// the reference gets this via libcontainer's vendored seccomp profile):
// container-escape and host-tamper vectors (mount family, module loading,
// reboot, kexec, raw io ports, clock setting, bpf, userfaultfd, ...)
// return EPERM inside the task while everything else proceeds normally.
// Applied with PR_SET_NO_NEW_PRIVS immediately before exec, after all
// shepherd-side setup (which itself needs mount/sethostname).
//
// --chroot pivots the task into D after read-only bind-mounting the
// default chroot env (/bin /usr /lib ... — the reference's
// config.DefaultChrootEnv, drivers/shared/executor): the task then sees
// only its own task dir plus immutable system paths.
//
// --cgroup enables best-effort resource limits (the executor's
// resource-container role, drivers/shared/executor resourceContainer):
// cgroup v2 unified (memory.max / cpu.weight) when available, else
// cgroup v1 memory/cpu controllers. The task enters the group before
// exec; the shepherd removes the group after the namespace empties.
//
// exit codes: task's own status, or 125 for shepherd-level failures.

#include <errno.h>
#include <fcntl.h>
#include <linux/audit.h>
#include <linux/filter.h>
#include <linux/seccomp.h>
#include <sched.h>
#include <signal.h>
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mount.h>
#include <sys/prctl.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

static const int SHEPHERD_ERR = 125;
static pid_t task_pid = -1;

// ---------------------------------------------------------------------------
// seccomp: fixed-BPF denylist (SURVEY §2.9; the reference vendors
// libseccomp via libcontainer — a hand-built cBPF program needs no
// library and the profile is static anyway)
// ---------------------------------------------------------------------------

#if defined(__x86_64__)
#define NSEXEC_AUDIT_ARCH AUDIT_ARCH_X86_64
#elif defined(__aarch64__)
#define NSEXEC_AUDIT_ARCH AUDIT_ARCH_AARCH64
#elif defined(__i386__)
#define NSEXEC_AUDIT_ARCH AUDIT_ARCH_I386
#else
#define NSEXEC_AUDIT_ARCH 0
#endif

// syscalls denied under --seccomp default: kernel/host tampering and
// container-escape vectors (docker's default-profile denials that matter
// for an already-namespaced task). Guarded per-arch: a number missing on
// this architecture simply isn't filtered.
static const long DENIED_SYSCALLS[] = {
#ifdef __NR_mount
    __NR_mount,
#endif
#ifdef __NR_umount2
    __NR_umount2,
#endif
#ifdef __NR_pivot_root
    __NR_pivot_root,
#endif
#ifdef __NR_chroot
    __NR_chroot,
#endif
#ifdef __NR_init_module
    __NR_init_module,
#endif
#ifdef __NR_finit_module
    __NR_finit_module,
#endif
#ifdef __NR_delete_module
    __NR_delete_module,
#endif
#ifdef __NR_kexec_load
    __NR_kexec_load,
#endif
#ifdef __NR_kexec_file_load
    __NR_kexec_file_load,
#endif
#ifdef __NR_reboot
    __NR_reboot,
#endif
#ifdef __NR_swapon
    __NR_swapon,
#endif
#ifdef __NR_swapoff
    __NR_swapoff,
#endif
#ifdef __NR_settimeofday
    __NR_settimeofday,
#endif
#ifdef __NR_clock_settime
    __NR_clock_settime,
#endif
#ifdef __NR_clock_adjtime
    __NR_clock_adjtime,
#endif
#ifdef __NR_adjtimex
    __NR_adjtimex,
#endif
#ifdef __NR_iopl
    __NR_iopl,
#endif
#ifdef __NR_ioperm
    __NR_ioperm,
#endif
#ifdef __NR_acct
    __NR_acct,
#endif
#ifdef __NR_quotactl
    __NR_quotactl,
#endif
#ifdef __NR_bpf
    __NR_bpf,
#endif
#ifdef __NR_userfaultfd
    __NR_userfaultfd,
#endif
#ifdef __NR_perf_event_open
    __NR_perf_event_open,
#endif
#ifdef __NR_open_by_handle_at
    __NR_open_by_handle_at,
#endif
#ifdef __NR_add_key
    __NR_add_key,
#endif
#ifdef __NR_request_key
    __NR_request_key,
#endif
#ifdef __NR_keyctl
    __NR_keyctl,
#endif
#ifdef __NR_ptrace
    __NR_ptrace,
#endif
#ifdef __NR_process_vm_readv
    __NR_process_vm_readv,
#endif
#ifdef __NR_process_vm_writev
    __NR_process_vm_writev,
#endif
#ifdef __NR_setns
    __NR_setns,
#endif
#ifdef __NR_unshare
    __NR_unshare,
#endif
#ifdef __NR_mknod
    __NR_mknod,
#endif
#ifdef __NR_mknodat
    __NR_mknodat,
#endif
#ifdef __NR_nfsservctl
    __NR_nfsservctl,
#endif
#ifdef __NR_personality
    __NR_personality,
#endif
#ifdef __NR_vhangup
    __NR_vhangup,
#endif
};

#define N_DENIED (sizeof(DENIED_SYSCALLS) / sizeof(DENIED_SYSCALLS[0]))

#ifndef SECCOMP_RET_KILL_PROCESS
#define SECCOMP_RET_KILL_PROCESS SECCOMP_RET_KILL
#endif

// Build and install: ARCH check, then one JEQ → RET ERRNO(EPERM) per
// denied number, default ALLOW. Denials return EPERM (not SIGKILL) so a
// task probing a denied call sees a normal error, matching the
// reference profile's errno action.
static int install_seccomp(void) {
  if (NSEXEC_AUDIT_ARCH == 0) {
    fprintf(stderr, "nsexec: seccomp unsupported on this architecture\n");
    return -1;
  }
  // 3 arch-check + 1 nr-load + 2 x32-guard + 2 per denial + 1 default-allow
  struct sock_filter prog[7 + 2 * N_DENIED];
  size_t n = 0;
  // [0] load arch, kill on mismatch (a foreign-arch syscall table would
  // make every JEQ below meaningless)
  prog[n++] = (struct sock_filter)BPF_STMT(
      BPF_LD | BPF_W | BPF_ABS, offsetof(struct seccomp_data, arch));
  prog[n++] = (struct sock_filter)BPF_JUMP(BPF_JMP | BPF_JEQ | BPF_K,
                                           NSEXEC_AUDIT_ARCH, 1, 0);
  prog[n++] = (struct sock_filter)BPF_STMT(BPF_RET | BPF_K,
                                           SECCOMP_RET_KILL_PROCESS);
  // [1] load the syscall number once
  prog[n++] = (struct sock_filter)BPF_STMT(
      BPF_LD | BPF_W | BPF_ABS, offsetof(struct seccomp_data, nr));
#if defined(__x86_64__)
  // x32 ABI syscalls (__X32_SYSCALL_BIT set) report AUDIT_ARCH_X86_64 but
  // use different numbers — without this guard every denial below is
  // bypassable via syscall(0x40000000|nr). Same hole docker's default
  // profile closes.
  prog[n++] = (struct sock_filter)BPF_JUMP(BPF_JMP | BPF_JGE | BPF_K,
                                           0x40000000u, 0, 1);
  prog[n++] = (struct sock_filter)BPF_STMT(
      BPF_RET | BPF_K, SECCOMP_RET_ERRNO | (EPERM & SECCOMP_RET_DATA));
#endif
  for (size_t d = 0; d < N_DENIED; d++) {
    prog[n++] = (struct sock_filter)BPF_JUMP(
        BPF_JMP | BPF_JEQ | BPF_K, (unsigned)DENIED_SYSCALLS[d], 0, 1);
    prog[n++] = (struct sock_filter)BPF_STMT(
        BPF_RET | BPF_K, SECCOMP_RET_ERRNO | (EPERM & SECCOMP_RET_DATA));
  }
  prog[n++] = (struct sock_filter)BPF_STMT(BPF_RET | BPF_K,
                                           SECCOMP_RET_ALLOW);

  struct sock_fprog fprog;
  fprog.len = (unsigned short)n;
  fprog.filter = prog;
  // required for an unprivileged process to install a filter; also the
  // right hardening default for task workloads
  if (prctl(PR_SET_NO_NEW_PRIVS, 1, 0, 0, 0) != 0) {
    fprintf(stderr, "nsexec: no_new_privs: %s\n", strerror(errno));
    return -1;
  }
  if (prctl(PR_SET_SECCOMP, SECCOMP_MODE_FILTER, &fprog) != 0) {
    fprintf(stderr, "nsexec: seccomp: %s\n", strerror(errno));
    return -1;
  }
  return 0;
}

static int write_file(const char *path, const char *value) {
  int fd = open(path, O_WRONLY);
  if (fd < 0) return -1;
  ssize_t n = write(fd, value, strlen(value));
  close(fd);
  return n < 0 ? -1 : 0;
}

// cgroup state shared with the child via these globals (set before fork)
static char cg_mem_dir[512] = "";
static char cg_cpu_dir[512] = "";
static int cg_v2 = 0;

static void setup_cgroups(const char *name, long memory_mb, long cpu_shares) {
  char buf[64];
  if (access("/sys/fs/cgroup/cgroup.controllers", R_OK) == 0) {
    // unified v2 hierarchy
    cg_v2 = 1;
    snprintf(cg_mem_dir, sizeof cg_mem_dir, "/sys/fs/cgroup/nomad-%s", name);
    if (mkdir(cg_mem_dir, 0755) != 0 && errno != EEXIST) {
      fprintf(stderr, "nsexec: warning: cgroup mkdir: %s\n", strerror(errno));
      cg_mem_dir[0] = '\0';
      return;
    }
    char path[600];
    if (memory_mb > 0) {
      snprintf(path, sizeof path, "%s/memory.max", cg_mem_dir);
      snprintf(buf, sizeof buf, "%ld", memory_mb * 1024 * 1024);
      if (write_file(path, buf) != 0)
        fprintf(stderr, "nsexec: warning: memory.max: %s\n", strerror(errno));
      // no swap escape hatch: over-limit must kill, not page out
      snprintf(path, sizeof path, "%s/memory.swap.max", cg_mem_dir);
      write_file(path, "0");
    }
    if (cpu_shares > 0) {
      // v2 weight 1..10000; map shares (1024 default) proportionally
      long weight = cpu_shares * 100 / 1024;
      if (weight < 1) weight = 1;
      if (weight > 10000) weight = 10000;
      snprintf(path, sizeof path, "%s/cpu.weight", cg_mem_dir);
      snprintf(buf, sizeof buf, "%ld", weight);
      if (write_file(path, buf) != 0)
        fprintf(stderr, "nsexec: warning: cpu.weight: %s\n", strerror(errno));
    }
    return;
  }
  // v1 split hierarchies
  if (memory_mb > 0) {
    snprintf(cg_mem_dir, sizeof cg_mem_dir,
             "/sys/fs/cgroup/memory/nomad-%s", name);
    if (mkdir(cg_mem_dir, 0755) == 0 || errno == EEXIST) {
      char path[600];
      snprintf(path, sizeof path, "%s/memory.limit_in_bytes", cg_mem_dir);
      snprintf(buf, sizeof buf, "%ld", memory_mb * 1024 * 1024);
      if (write_file(path, buf) != 0)
        fprintf(stderr, "nsexec: warning: memory limit: %s\n", strerror(errno));
      // cap memory+swap at the same limit (kill instead of paging out)
      snprintf(path, sizeof path, "%s/memory.memsw.limit_in_bytes", cg_mem_dir);
      write_file(path, buf);
    } else {
      fprintf(stderr, "nsexec: warning: memory cgroup: %s\n", strerror(errno));
      cg_mem_dir[0] = '\0';
    }
  }
  if (cpu_shares > 0) {
    snprintf(cg_cpu_dir, sizeof cg_cpu_dir, "/sys/fs/cgroup/cpu/nomad-%s", name);
    if (mkdir(cg_cpu_dir, 0755) == 0 || errno == EEXIST) {
      char path[600];
      snprintf(path, sizeof path, "%s/cpu.shares", cg_cpu_dir);
      snprintf(buf, sizeof buf, "%ld", cpu_shares);
      if (write_file(path, buf) != 0)
        fprintf(stderr, "nsexec: warning: cpu shares: %s\n", strerror(errno));
    } else {
      fprintf(stderr, "nsexec: warning: cpu cgroup: %s\n", strerror(errno));
      cg_cpu_dir[0] = '\0';
    }
  }
}

static void enter_cgroups(void) {
  // writing "0" adds the calling process; done by the task child pre-exec
  char path[600];
  if (cg_mem_dir[0]) {
    snprintf(path, sizeof path, "%s/cgroup.procs", cg_mem_dir);
    if (write_file(path, "0") != 0)
      fprintf(stderr, "nsexec: warning: cgroup join: %s\n", strerror(errno));
  }
  if (!cg_v2 && cg_cpu_dir[0]) {
    snprintf(path, sizeof path, "%s/cgroup.procs", cg_cpu_dir);
    if (write_file(path, "0") != 0)
      fprintf(stderr, "nsexec: warning: cpu cgroup join: %s\n", strerror(errno));
  }
}

static void cleanup_cgroups(void) {
  if (cg_mem_dir[0]) rmdir(cg_mem_dir);
  if (cg_cpu_dir[0]) rmdir(cg_cpu_dir);
}

static void forward_signal(int sig) {
  if (task_pid > 0) kill(task_pid, sig);
}

// the full set the driver's SignalTask can deliver; TERM/INT kill, the
// rest (HUP/USR1/USR2/QUIT) are app-level signals the task may trap
static void install_forwarders(void) {
  signal(SIGTERM, forward_signal);
  signal(SIGINT, forward_signal);
  signal(SIGHUP, forward_signal);
  signal(SIGUSR1, forward_signal);
  signal(SIGUSR2, forward_signal);
  signal(SIGQUIT, forward_signal);
}

// default chroot env (ref client/allocdir config.DefaultChrootEnv):
// host path → same path inside the chroot, read-only
static const char *CHROOT_PATHS[] = {
    "/bin", "/usr", "/lib", "/lib32", "/lib64", "/sbin",
    "/etc/ld.so.cache", "/etc/ld.so.conf", "/etc/ld.so.conf.d",
    "/etc/passwd", "/etc/group", "/etc/resolv.conf", "/etc/ssl",
    "/etc/alternatives", NULL,
};

static int mkdirs(char *path) {
  // mkdir -p; mutates path temporarily
  for (char *p = path + 1; *p; p++) {
    if (*p == '/') {
      *p = '\0';
      if (mkdir(path, 0755) != 0 && errno != EEXIST) { *p = '/'; return -1; }
      *p = '/';
    }
  }
  if (mkdir(path, 0755) != 0 && errno != EEXIST) return -1;
  return 0;
}

static int bind_readonly(const char *src, const char *dst, int is_dir) {
  if (is_dir) {
    char tmp[1024];
    snprintf(tmp, sizeof tmp, "%s", dst);
    if (mkdirs(tmp) != 0) return -1;
  } else {
    // bind target for a file must be an existing file
    char tmp[1024];
    snprintf(tmp, sizeof tmp, "%s", dst);
    char *slash = strrchr(tmp, '/');
    if (slash) { *slash = '\0'; if (mkdirs(tmp) != 0) return -1; *slash = '/'; }
    int fd = open(dst, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) return -1;
    close(fd);
  }
  if (mount(src, dst, NULL, MS_BIND | MS_REC, NULL) != 0) return -1;
  // bind mounts need a remount to actually apply MS_RDONLY
  mount(NULL, dst, NULL, MS_REMOUNT | MS_BIND | MS_RDONLY | MS_NOSUID, NULL);
  return 0;
}

// writable binds into the chroot (the alloc shared dir's mount: the
// reference bind-mounts alloc/ into every task container at /alloc)
#define MAX_BINDS 16
static const char *bind_src[MAX_BINDS];
static const char *bind_dst[MAX_BINDS];
static int n_binds = 0;

static int setup_chroot(const char *root) {
  char dst[1024];
  struct stat st;
  for (int i = 0; CHROOT_PATHS[i] != NULL; i++) {
    const char *src = CHROOT_PATHS[i];
    if (stat(src, &st) != 0) continue;  // absent on this host: skip
    snprintf(dst, sizeof dst, "%s%s", root, src);
    if (bind_readonly(src, dst, S_ISDIR(st.st_mode)) != 0)
      fprintf(stderr, "nsexec: warning: chroot bind %s: %s\n", src,
              strerror(errno));
  }
  // private scratch + dev essentials inside the root
  snprintf(dst, sizeof dst, "%s/tmp", root);
  mkdir(dst, 01777);
  snprintf(dst, sizeof dst, "%s/dev", root);
  mkdir(dst, 0755);
  const char *devs[] = {"null", "zero", "urandom", "random", NULL};
  for (int i = 0; devs[i] != NULL; i++) {
    char src[64];
    snprintf(src, sizeof src, "/dev/%s", devs[i]);
    snprintf(dst, sizeof dst, "%s/dev/%s", root, devs[i]);
    if (stat(src, &st) == 0) {
      int fd = open(dst, O_WRONLY | O_CREAT, 0666);
      if (fd >= 0) close(fd);
      if (mount(src, dst, NULL, MS_BIND, NULL) != 0)
        fprintf(stderr, "nsexec: warning: bind %s: %s\n", src, strerror(errno));
    }
  }
  // writable binds (alloc shared dir etc.)
  for (int i = 0; i < n_binds; i++) {
    snprintf(dst, sizeof dst, "%s%s", root, bind_dst[i]);
    char tmp[1024];
    snprintf(tmp, sizeof tmp, "%s", dst);
    if (mkdirs(tmp) != 0 ||
        mount(bind_src[i], dst, NULL, MS_BIND | MS_REC, NULL) != 0)
      fprintf(stderr, "nsexec: warning: bind %s -> %s: %s\n", bind_src[i],
              bind_dst[i], strerror(errno));
  }
  // the namespace-local /proc must live INSIDE the new root
  snprintf(dst, sizeof dst, "%s/proc", root);
  mkdir(dst, 0555);
  if (mount("proc", dst, "proc", MS_NOSUID | MS_NODEV | MS_NOEXEC, NULL) != 0)
    fprintf(stderr, "nsexec: warning: chroot /proc: %s\n", strerror(errno));
  if (chroot(root) != 0) {
    fprintf(stderr, "nsexec: chroot %s: %s\n", root, strerror(errno));
    return -1;
  }
  if (chdir("/") != 0) return -1;
  return 0;
}

static int ns_flags() {
  return CLONE_NEWPID | CLONE_NEWNS | CLONE_NEWIPC | CLONE_NEWUTS;
}

// --enter PID: join an existing task's namespaces and run a command inside
// them — the exec driver's exec-in-context path (the reference re-enters
// via its nsenter shim for ExecTaskStreaming,
// plugins/drivers/proto/driver.proto:72-76). Opens the target's ns fds
// first (they stay valid even if the target exits mid-setns), joins
// mnt/ipc/uts, then pid last, forks so the child is born inside the pid
// namespace, and propagates the child's exit status.
// Best-effort: place the calling process in the target's cgroup(s) so an
// exec'd command inherits the task's memory/cpu limits (the reference puts
// ExecTaskStreaming processes into the task cgroup). Parses
// /proc/<pid>/cgroup: "0::<path>" (v2 unified) and "N:<ctrl>:<path>" (v1).
// Must run BEFORE setns(mnt) — the target's mount view may hide
// /sys/fs/cgroup.
static void join_target_cgroups(pid_t target) {
  char path[64], line[768];
  snprintf(path, sizeof path, "/proc/%d/cgroup", (int)target);
  FILE *f = fopen(path, "r");
  if (f == NULL) return;
  while (fgets(line, sizeof line, f) != NULL) {
    line[strcspn(line, "\n")] = '\0';
    char *c1 = strchr(line, ':');
    if (c1 == NULL) continue;
    char *c2 = strchr(c1 + 1, ':');
    if (c2 == NULL) continue;
    *c2 = '\0';
    const char *ctrl = c1 + 1;
    const char *cpath = c2 + 1;
    if (strcmp(cpath, "/") == 0) continue;
    char procs[1024];
    if (*ctrl == '\0') {  // v2 unified hierarchy
      snprintf(procs, sizeof procs, "/sys/fs/cgroup%s/cgroup.procs", cpath);
    } else if (strstr(ctrl, "memory") != NULL || strstr(ctrl, "cpu") != NULL) {
      snprintf(procs, sizeof procs, "/sys/fs/cgroup/%s%s/cgroup.procs", ctrl,
               cpath);
    } else {
      continue;
    }
    if (write_file(procs, "0") != 0)
      fprintf(stderr, "nsexec: warning: cgroup join %s: %s\n", procs,
              strerror(errno));
  }
  fclose(f);
}

static int enter_namespaces(pid_t target, char **cmd,
                            const char *seccomp_profile) {
  const char *names[] = {"mnt", "ipc", "uts", "pid"};
  int fds[4];
  char path[64];
  for (int i = 0; i < 4; i++) {
    snprintf(path, sizeof path, "/proc/%d/ns/%s", (int)target, names[i]);
    fds[i] = open(path, O_RDONLY);
    if (fds[i] < 0) {
      fprintf(stderr, "nsexec: open %s: %s\n", path, strerror(errno));
      return SHEPHERD_ERR;
    }
  }
  join_target_cgroups(target);
  for (int i = 0; i < 4; i++) {
    if (setns(fds[i], 0) != 0) {
      fprintf(stderr, "nsexec: setns %s: %s\n", names[i], strerror(errno));
      return SHEPHERD_ERR;
    }
    close(fds[i]);
  }
  // joining the pid ns affects children only: fork so the command runs
  // inside, shepherd waits outside
  pid_t pid = fork();
  if (pid < 0) return SHEPHERD_ERR;
  if (pid == 0) {
    // mnt join already switched root/cwd to the target's; stay at /
    if (chdir("/") != 0) { /* best effort */ }
    // an exec'd process must inherit the task's filter (the reference
    // exec path inherits the container's seccomp profile) — otherwise
    // `nomad alloc exec` is an unfiltered shell inside the sandbox
    if (seccomp_profile != NULL && strcmp(seccomp_profile, "default") == 0) {
      if (install_seccomp() != 0) _exit(SHEPHERD_ERR);
    }
    execvp(cmd[0], cmd);
    fprintf(stderr, "nsexec: exec %s: %s\n", cmd[0], strerror(errno));
    _exit(127);
  }
  int status = 0;
  while (waitpid(pid, &status, 0) < 0 && errno == EINTR) {
  }
  if (WIFEXITED(status)) return WEXITSTATUS(status);
  if (WIFSIGNALED(status)) return 128 + WTERMSIG(status);
  return SHEPHERD_ERR;
}

static int check_isolation() {
  // fork first: unshare(CLONE_NEWPID) changes what fork() creates, and we
  // don't want to disturb the caller's process
  pid_t pid = fork();
  if (pid < 0) return 1;
  if (pid == 0) {
    _exit(unshare(ns_flags()) == 0 ? 0 : 1);
  }
  int status = 0;
  if (waitpid(pid, &status, 0) < 0) return 1;
  return WIFEXITED(status) ? WEXITSTATUS(status) : 1;
}

int main(int argc, char **argv) {
  const char *workdir = NULL;
  const char *hostname = "nomad-task";
  const char *cgroup = NULL;
  const char *chroot_dir = NULL;
  const char *seccomp_profile = NULL;
  long memory_mb = 0;
  long cpu_shares = 0;
  int i = 1;
  long enter_pid = 0;
  for (; i < argc; i++) {
    if (strcmp(argv[i], "--check") == 0) {
      return check_isolation();
    } else if (strcmp(argv[i], "--enter") == 0 && i + 1 < argc) {
      enter_pid = atol(argv[++i]);
    } else if (strcmp(argv[i], "--workdir") == 0 && i + 1 < argc) {
      workdir = argv[++i];
    } else if (strcmp(argv[i], "--hostname") == 0 && i + 1 < argc) {
      hostname = argv[++i];
    } else if (strcmp(argv[i], "--cgroup") == 0 && i + 1 < argc) {
      cgroup = argv[++i];
    } else if (strcmp(argv[i], "--chroot") == 0 && i + 1 < argc) {
      chroot_dir = argv[++i];
    } else if (strcmp(argv[i], "--bind") == 0 && i + 1 < argc) {
      // SRC:DST with DST relative to the chroot root
      char *spec = argv[++i];
      char *colon = strrchr(spec, ':');
      if (colon == NULL || n_binds >= MAX_BINDS) {
        fprintf(stderr, "nsexec: bad --bind %s\n", spec);
        return SHEPHERD_ERR;
      }
      *colon = '\0';
      bind_src[n_binds] = spec;
      bind_dst[n_binds] = colon + 1;
      n_binds++;
    } else if (strcmp(argv[i], "--memory-mb") == 0 && i + 1 < argc) {
      memory_mb = atol(argv[++i]);
    } else if (strcmp(argv[i], "--cpu-shares") == 0 && i + 1 < argc) {
      cpu_shares = atol(argv[++i]);
    } else if (strcmp(argv[i], "--seccomp") == 0 && i + 1 < argc) {
      seccomp_profile = argv[++i];
      if (strcmp(seccomp_profile, "default") != 0 &&
          strcmp(seccomp_profile, "off") != 0) {
        fprintf(stderr, "nsexec: unknown seccomp profile %s\n",
                seccomp_profile);
        return SHEPHERD_ERR;
      }
    } else if (strcmp(argv[i], "--") == 0) {
      i++;
      break;
    } else {
      fprintf(stderr, "nsexec: unknown argument %s\n", argv[i]);
      return SHEPHERD_ERR;
    }
  }
  if (i >= argc) {
    fprintf(stderr, "nsexec: no command\n");
    return SHEPHERD_ERR;
  }
  char **cmd = &argv[i];

  if (enter_pid > 0) {
    return enter_namespaces((pid_t)enter_pid, cmd, seccomp_profile);
  }

  if (cgroup != NULL) setup_cgroups(cgroup, memory_mb, cpu_shares);

  if (unshare(ns_flags()) != 0) {
    fprintf(stderr, "nsexec: unshare: %s\n", strerror(errno));
    cleanup_cgroups();
    return SHEPHERD_ERR;
  }

  // first fork after unshare(CLONE_NEWPID) becomes pid 1 of the new ns
  pid_t init_pid = fork();
  if (init_pid < 0) return SHEPHERD_ERR;

  if (init_pid > 0) {
    // outer shepherd: forward signals to the namespace init, propagate exit
    task_pid = init_pid;
    install_forwarders();
    int status = 0;
    while (waitpid(init_pid, &status, 0) < 0 && errno == EINTR) {
    }
    cleanup_cgroups();  // namespace empty: the group can be removed
    if (WIFEXITED(status)) return WEXITSTATUS(status);
    if (WIFSIGNALED(status)) return 128 + WTERMSIG(status);
    return SHEPHERD_ERR;
  }

  // namespace init (pid 1 inside): private mounts, own /proc, supervise task
  if (mount(NULL, "/", NULL, MS_REC | MS_PRIVATE, NULL) != 0) {
    fprintf(stderr, "nsexec: private mounts: %s\n", strerror(errno));
    _exit(SHEPHERD_ERR);
  }
  if (chroot_dir != NULL) {
    if (setup_chroot(chroot_dir) != 0) _exit(SHEPHERD_ERR);
    // the task dir is now "/"; a --workdir under it is re-rooted
    workdir = "/";
  } else if (mount("proc", "/proc", "proc",
                   MS_NOSUID | MS_NODEV | MS_NOEXEC, NULL) != 0) {
    // non-fatal: /proc may be read-only in constrained sandboxes
    fprintf(stderr, "nsexec: warning: mount /proc: %s\n", strerror(errno));
  }
  if (sethostname(hostname, strlen(hostname)) != 0) {
    fprintf(stderr, "nsexec: warning: sethostname: %s\n", strerror(errno));
  }

  pid_t child = fork();
  if (child < 0) _exit(SHEPHERD_ERR);
  if (child == 0) {
    enter_cgroups();  // join before exec so the limits cover the task
    if (workdir && chdir(workdir) != 0) {
      fprintf(stderr, "nsexec: chdir %s: %s\n", workdir, strerror(errno));
      _exit(SHEPHERD_ERR);
    }
    prctl(PR_SET_PDEATHSIG, SIGKILL);
    // last setup step before exec: the filter survives execve and the
    // shepherd-side mount/sethostname above stay unfiltered
    if (seccomp_profile != NULL && strcmp(seccomp_profile, "default") == 0) {
      if (install_seccomp() != 0) _exit(SHEPHERD_ERR);
    }
    execvp(cmd[0], cmd);
    fprintf(stderr, "nsexec: exec %s: %s\n", cmd[0], strerror(errno));
    _exit(SHEPHERD_ERR);
  }

  // pid 1 must install handlers explicitly — default dispositions are
  // ignored for a namespace's init
  task_pid = child;
  install_forwarders();

  int code = SHEPHERD_ERR;
  for (;;) {
    int status = 0;
    pid_t done = waitpid(-1, &status, 0);
    if (done < 0) {
      if (errno == EINTR) continue;
      break;  // ECHILD: everything reaped
    }
    if (done == child) {
      if (WIFEXITED(status)) code = WEXITSTATUS(status);
      else if (WIFSIGNALED(status)) code = 128 + WTERMSIG(status);
      // keep reaping until all namespace descendants are gone
    }
  }
  _exit(code);
}
