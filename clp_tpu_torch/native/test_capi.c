/* End-to-end C API test: build a tiny LP in pure C, solve, check results.
 * Problem: max 2a+3b s.t. a+b<=4, a+3b<=6, a,b>=0 -> a=3, b=1, obj 9.
 * Compiled and run by tests/test_torch_cli.py and chip_smoke.py. */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>

#include "ClpTpu_C_Interface.h"

static int g_callback_count = 0;
static void my_callback(ClpTpuModel *model, int messageNumber, int nDouble,
                        const double *vDouble, int nInt, const int *vInt,
                        int nString, char **vString) {
  (void)model; (void)nDouble; (void)vDouble; (void)nInt; (void)vInt;
  g_callback_count++;
  if (nString > 0 && g_callback_count <= 2)
    printf("[callback %d] %s\n", messageNumber, vString[0]);
}

int main(void) {
  if (ClpTpu_initialize() != 0) {
    fprintf(stderr, "init failed\n");
    return 2;
  }
  ClpTpuModel *m = ClpTpu_newModel();
  if (!m) {
    fprintf(stderr, "newModel failed\n");
    return 2;
  }
  /* CSC for [[1,1],[1,3]] */
  long long start[3] = {0, 2, 4};
  int index[4] = {0, 1, 0, 1};
  double value[4] = {1.0, 1.0, 1.0, 3.0};
  double collb[2] = {0.0, 0.0};
  double colub[2] = {1e30, 1e30};
  double obj[2] = {2.0, 3.0};
  double rowlb[2] = {-1e30, -1e30};
  double rowub[2] = {4.0, 6.0};
  if (ClpTpu_loadProblem(m, 2, 2, start, index, value, collb, colub, obj,
                         rowlb, rowub) != 0) {
    fprintf(stderr, "loadProblem failed\n");
    return 2;
  }
  ClpTpu_setObjSense(m, -1.0); /* maximize */
  int st = ClpTpu_dual(m);
  double ov = ClpTpu_objectiveValue(m);
  double x[2] = {0, 0}, y[2] = {0, 0};
  ClpTpu_primalColumnSolution(m, x, 2);
  ClpTpu_dualRowSolution(m, y, 2);
  printf("status=%d obj=%.9f x=[%.6f %.6f] rows=%d cols=%d iters=%d\n", st, ov,
         x[0], x[1], ClpTpu_numberRows(m), ClpTpu_numberColumns(m),
         ClpTpu_numberIterations(m));
  int ok = st == 0 && fabs(ov - 9.0) < 1e-7 && fabs(x[0] - 3.0) < 1e-7 &&
           fabs(x[1] - 1.0) < 1e-7;
  /* values pass: restart from the solved values, must stay optimal */
  int stv = ClpTpu_dualWithValuesPass(m, 1);
  double ovv = ClpTpu_objectiveValue(m);
  if (stv != 0 || fabs(ovv - 9.0) > 1e-7) {
    fprintf(stderr, "values pass failed st=%d obj=%f\n", stv, ovv);
    return 1;
  }
  ClpTpu_deleteModel(m);
  if (!ok) {
    fprintf(stderr, "WRONG ANSWER\n");
    return 1;
  }

  /* NULL rim pointers must take Clp defaults (collb=0, colub=+inf, obj=0,
   * rowlb=-inf, rowub=+inf) instead of segfaulting. */
  ClpTpuModel *m2 = ClpTpu_newModel();
  if (!m2) return 2;
  if (ClpTpu_loadProblem(m2, 2, 2, start, index, value, NULL, NULL, NULL,
                         NULL, rowub) != 0) {
    fprintf(stderr, "NULL-rim loadProblem failed\n");
    return 2;
  }
  int st2 = ClpTpu_dual(m2); /* zero objective: any feasible point, obj 0 */
  double ov2 = ClpTpu_objectiveValue(m2);
  ClpTpu_deleteModel(m2);
  if (st2 != 0 || fabs(ov2) > 1e-9) {
    fprintf(stderr, "NULL-rim WRONG ANSWER status=%d obj=%g\n", st2, ov2);
    return 1;
  }

  /* --- extended surface: edits, params, status arrays, options object --- */
  ClpTpuModel *m3 = ClpTpu_newModel();
  if (ClpTpu_loadProblem(m3, 2, 2, start, index, value, collb, colub, obj,
                         rowlb, rowub) != 0)
    return 2;
  ClpTpu_setObjSense(m3, -1.0);
  ClpTpu_setPrimalTolerance(m3, 1e-8);
  if (fabs(ClpTpu_primalTolerance(m3) - 1e-8) > 1e-15) {
    fprintf(stderr, "tolerance get/set broken\n");
    return 1;
  }
  /* add a column with objective 10 entering both rows: new optimum uses it */
  long long cst[2] = {0, 2};
  int crows[2] = {0, 1};
  double cels[2] = {1.0, 1.0};
  double clo[1] = {0.0}, cup[1] = {1.0}, cob[1] = {10.0};
  ClpTpu_addColumns(m3, 1, clo, cup, cob, cst, crows, cels);
  if (ClpTpu_numberColumns(m3) != 3) {
    fprintf(stderr, "addColumns failed\n");
    return 1;
  }
  /* matrix query */
  if (ClpTpu_getNumElements(m3) != 6) {
    fprintf(stderr, "getNumElements wrong\n");
    return 1;
  }
  const long long *starts = ClpTpu_getVectorStarts(m3);
  const double *els = ClpTpu_getElements(m3);
  if (!starts || starts[3] != 6 || !els) {
    fprintf(stderr, "matrix queries broken\n");
    return 1;
  }
  ClpTpuSolve *opts = ClpTpuSolve_new();
  ClpTpuSolve_setSolveType(opts, 0, 0); /* dual */
  ClpTpuSolve_setPresolveType(opts, 0, 0);
  int st3 = ClpTpu_initialSolveWithOptions(m3, opts);
  ClpTpuSolve_delete(opts);
  double ov3 = ClpTpu_getObjValue(m3);
  if (st3 != 0 || !ClpTpu_isProvenOptimal(m3)) {
    fprintf(stderr, "solveWithOptions failed st=%d\n", st3);
    return 1;
  }
  /* with the new column: max 2a+3b+10c, c<=1 -> c=1, then a+b<=3, a+3b<=5
   * -> a=2,b=1 -> 2*2+3*1+10 = 17 */
  if (fabs(ov3 - 17.0) > 1e-6) {
    fprintf(stderr, "edited-model objective wrong: %g\n", ov3);
    return 1;
  }
  if (!ClpTpu_statusExists(m3)) {
    fprintf(stderr, "statusExists false after solve\n");
    return 1;
  }
  unsigned char *sa = ClpTpu_statusArray(m3);
  if (!sa) {
    fprintf(stderr, "statusArray NULL\n");
    return 1;
  }
  int cstat = ClpTpu_getColumnStatus(m3, 2); /* c at upper bound = 2 */
  if (cstat != 2) {
    fprintf(stderr, "column status wrong: %d\n", cstat);
    return 1;
  }
  if (ClpTpu_numberPrimalInfeasibilities(m3) != 0 ||
      !ClpTpu_primalFeasible(m3)) {
    fprintf(stderr, "feasibility accounting wrong\n");
    return 1;
  }
  const double *act = ClpTpu_getRowActivity(m3);
  if (!act || fabs(act[0] - 4.0) > 1e-6) {
    fprintf(stderr, "row activity wrong\n");
    return 1;
  }
  ClpTpu_setUserPointer(m3, (void *)0x42);
  if (ClpTpu_getUserPointer(m3) != (void *)0x42) return 1;
  char name[64];
  ClpTpu_setColumnName(m3, 0, "alpha");
  ClpTpu_columnName(m3, 0, name);
  if (name[0] != 'a') {
    fprintf(stderr, "names broken: %s\n", name);
    return 1;
  }
  ClpTpu_deleteModel(m3);

  /* infeasible model: ray must be produced (presolve off via options) */
  ClpTpuModel *m4 = ClpTpu_newModel();
  double rl4[1] = {5.0}, ru4[1] = {1e30};
  long long st4s[3] = {0, 1, 2};
  int ix4[2] = {0, 0};
  double vv4[2] = {1.0, 1.0};
  double cub4[2] = {1.0, 1.0};
  if (ClpTpu_loadProblem(m4, 2, 1, st4s, ix4, vv4, NULL, cub4, NULL, rl4,
                         ru4) != 0)
    return 2;
  ClpTpuSolve *o4 = ClpTpuSolve_new();
  ClpTpuSolve_setSolveType(o4, 0, 0);
  ClpTpuSolve_setPresolveType(o4, 1, 0); /* presolve off */
  int st4 = ClpTpu_initialSolveWithOptions(m4, o4);
  ClpTpuSolve_delete(o4);
  if (st4 != 1 || !ClpTpu_isProvenPrimalInfeasible(m4)) {
    fprintf(stderr, "infeasible detection failed st=%d\n", st4);
    return 1;
  }
  double *ray = ClpTpu_infeasibilityRay(m4);
  if (!ray) {
    fprintf(stderr, "no infeasibility ray\n");
    return 1;
  }
  ClpTpu_freeRay(m4, ray);
  ClpTpu_deleteModel(m4);

  /* message callback: must fire during a solve (Clp_registerCallBack) */
  {
    ClpTpuModel *m5 = ClpTpu_newModel();
    long long st5[3] = {0, 2, 4};
    int ix5[4] = {0, 1, 0, 1};
    double vv5[4] = {1.0, 1.0, 1.0, 3.0};
    double cub5[2] = {1e30, 1e30};
    double rub5[2] = {4.0, 6.0};
    double obj5[2] = {2.0, 3.0};
    if (ClpTpu_loadProblem(m5, 2, 2, st5, ix5, vv5, NULL, cub5, obj5, NULL,
                           rub5) != 0)
      return 2;
    ClpTpu_setObjSense(m5, -1.0);
    ClpTpu_registerCallBack(m5, my_callback);
    if (ClpTpu_dual(m5) != 0 || g_callback_count == 0) {
      fprintf(stderr, "callback never fired (count=%d)\n", g_callback_count);
      return 1;
    }
    ClpTpu_clearCallBack(m5);
    int before = g_callback_count;
    ClpTpu_dual(m5);
    if (g_callback_count != before) {
      fprintf(stderr, "callback fired after clearCallBack\n");
      return 1;
    }
    /* quadratic objective: min -2a-2b+(a^2+b^2)/2 s.t. a+3b<=6 active:
       KKT gives a=1.8, b=1.4 (lambda=0.2) */
    ClpTpu_setObjSense(m5, 1.0);
    double objq[2] = {-2.0, -2.0};
    ClpTpu_chgObjCoefficients(m5, objq);
    long long qs[3] = {0, 1, 2};
    int qc[2] = {0, 1};
    double qv[2] = {1.0, 1.0};
    if (ClpTpu_loadQuadraticObjective(m5, 2, qs, qc, qv) != 0) {
      fprintf(stderr, "loadQuadraticObjective failed\n");
      return 1;
    }
    if (ClpTpu_initialBarrierNoCrossSolve(m5) != 0) {
      fprintf(stderr, "QP barrier solve failed\n");
      return 1;
    }
    double xq[2];
    ClpTpu_primalColumnSolution(m5, xq, 2);
    if (fabs(xq[0] - 1.8) > 1e-4 || fabs(xq[1] - 1.4) > 1e-4) {
      fprintf(stderr, "QP solution wrong: [%f %f]\n", xq[0], xq[1]);
      return 1;
    }
    ClpTpu_deleteModel(m5);
  }

  /* crash hooks: triangular crash loads a pending warm basis (pivot!=0),
     idiot leaves a values-pass point; both must leave the model solvable */
  {
    ClpTpuModel *m6 = ClpTpu_newModel();
    long long st6[3] = {0, 1, 2};
    int ix6[2] = {0, 1};
    double vv6[2] = {1.0, 1.0};
    double cub6[2] = {4.0, 4.0};
    double obj6[2] = {-1.0, -2.0};
    double rub6[2] = {3.0, 3.0};
    if (ClpTpu_loadProblem(m6, 2, 2, st6, ix6, vv6, NULL, cub6, obj6, NULL,
                           rub6) != 0)
      return 1;
    if (ClpTpu_crash(m6, 0.0, 1) != 0) {
      fprintf(stderr, "triangular crash failed\n");
      return 1;
    }
    if (ClpTpu_dual(m6) != 0 || ClpTpu_status(m6) != 0) {
      fprintf(stderr, "post-crash dual solve failed\n");
      return 1;
    }
    ClpTpu_idiot(m6, 10); /* values-pass point; must not error */
    ClpTpu_deleteModel(m6);
  }

  printf("C API test OK (extended surface)\n");
  return 0;
}
