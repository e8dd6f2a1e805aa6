/* Native POSIX shared-memory tensor store.
 *
 * Counterpart of the reference's Python shm store
 * (byzpy/engine/storage/shared_store.py:21-54, which delegates to
 * multiprocessing.shared_memory): create/map/unlink named segments with no
 * Python-level resource tracker in the loop — the tracker is precisely what
 * makes multiprocessing.shared_memory painful across independently spawned
 * actor processes (spurious unlinks at interpreter exit).
 *
 * Built as a plain shared library (no Python.h) and driven via ctypes, so
 * it compiles anywhere with a C compiler and loads lazily.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

/* Create (or open) a named shm segment of nbytes and map it.
 * mode: 1 = create exclusive (fails if exists), 0 = open existing.
 * Returns the mapped pointer, or NULL with *err set to errno. */
void *bshm_map(const char *name, uint64_t nbytes, int create, int *err) {
    int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
    int fd = shm_open(name, flags, 0600);
    if (fd < 0) {
        if (err) *err = errno;
        return NULL;
    }
    if (create && ftruncate(fd, (off_t)nbytes) != 0) {
        if (err) *err = errno;
        close(fd);
        shm_unlink(name);
        return NULL;
    }
    void *ptr = mmap(NULL, (size_t)nbytes, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    close(fd); /* mapping keeps the segment alive */
    if (ptr == MAP_FAILED) {
        if (err) *err = errno;
        if (create) shm_unlink(name);
        return NULL;
    }
    if (err) *err = 0;
    return ptr;
}

int bshm_unmap(void *ptr, uint64_t nbytes) {
    return munmap(ptr, (size_t)nbytes) == 0 ? 0 : errno;
}

int bshm_unlink(const char *name) {
    return shm_unlink(name) == 0 ? 0 : errno;
}

/* Size of an existing segment (0 on error, *err set). */
uint64_t bshm_size(const char *name, int *err) {
    int fd = shm_open(name, O_RDONLY, 0600);
    if (fd < 0) {
        if (err) *err = errno;
        return 0;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
        if (err) *err = errno;
        close(fd);
        return 0;
    }
    close(fd);
    if (err) *err = 0;
    return (uint64_t)st.st_size;
}
